"""The delta engine's run loops: PyTorch port against the JAX package.

``run_until_converged`` at 4096 x 64 through both packages, both exchanges,
with and without faults: the convergence tick, the final leaves, a budget
that ends before convergence and an already converged state; and
``DeltaSim``'s run and tick.  Apart from ``tests/test_torch_delta.py``
(the per-tick parity and the port's hazards) so that the test scheduler
can run the two on different workers.  The tolerance is none.
"""

import pytest
import torch

from ringpop_tpu.sim import delta as jd

from ringpop_tpu_torch.sim import delta as td
from test_torch_delta import _faults, _pair, assert_same_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("exchange,kind", [("shift", ""), ("shift", "up drop"), ("uniform", "up"),
                                           ("uniform", "group drop")])
def test_run_until_converged_matches_jax(exchange, kind):
    jp, tp = _pair(4096, 64, exchange)
    jf, tf = _faults(kind, 4096, seed=9)
    js, jticks, jok = jd.run_until_converged(jp, jd.init_state(jp, seed=5), jf, max_ticks=2048, check_every=4)
    ts, tticks, tok = td.run_until_converged(tp, td.init_state(tp, seed=5, device="cpu"), tf,
                                             max_ticks=2048, check_every=4)
    assert (tticks, tok) == (jticks, jok)
    assert_same_state(js, ts, "final")
    # a budget that ends before convergence, then an already converged state
    js2, jt2, jok2 = jd.run_until_converged(jp, jd.init_state(jp, seed=5), jf, max_ticks=6, check_every=4)
    ts2, tt2, tok2 = td.run_until_converged(tp, td.init_state(tp, seed=5, device="cpu"), tf, max_ticks=6,
                                            check_every=4)
    assert (tt2, tok2) == (jt2, jok2) == (8, False)
    assert_same_state(js2, ts2, "budget")
    if jok:
        ts3, tt3, tok3 = td.run_until_converged(tp, ts, tf, max_ticks=100)
        assert (tt3, tok3) == (0, True) and ts3 is ts


def test_delta_sim_matches_jax():
    jsim = jd.DeltaSim(3000, 33, seed=8, rng="counter", exchange="uniform")
    tsim = td.DeltaSim(3000, 33, seed=8, rng="counter", exchange="uniform", device="cpu")
    assert tsim.run_until_converged() == jsim.run_until_converged()
    assert_same_state(jsim.state, tsim.state)
    jsim.tick()
    tsim.tick()
    assert_same_state(jsim.state, tsim.state)
