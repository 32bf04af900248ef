"""The simbench twin's engine rows against the JAX package's, on the CPU at
simbench's non-full sizes, seed 0: ``loss1k``, ``sweep100k``,
``partition_lc`` (the lifecycle engine), ``partition1m`` and ``delta16m``
(the delta engine) and ``ring1m`` (the keyed ring).

Each test runs the JAX row and the port's row and holds every field of the
two records equal, but these, which are not exact:

- ``value`` of every row here, and ``detect_s``, ``blip_s``,
  ``converge_s`` (``partition_lc``): walls of the host clock;
- ``ring1m``'s ``value``, ``keyed_hash_lookup_qps`` (rates), ``build_s``
  and ``churn_rebalance_s`` (walls).

Beside the records, the engines' final states are held equal by their
``tree_digest`` (the JAX side's ``LifecycleSim`` and ``run_until_converged``
recorded through a wrapper), and ``ring1m``'s owners to a host
searchsorted.  ``delta16m`` at its non-full 2,000,000 nodes takes ~60 s in
the port on one thread, so its whole-row comparison is ``slow``; tier-1
runs the row's recipe at 100,000 nodes through both packages' public
functions.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ringpop_tpu.cli import simbench as jsb
from ringpop_tpu.sim import delta as jdelta, lifecycle as jlifecycle, telemetry as jtelemetry
from ringpop_tpu_torch.cli import simbench as tsb
from ringpop_tpu_torch.sim import delta as tdelta, telemetry as ttelemetry
from torch_simbench_compare import assert_rows_match

SEED = 0
CPU = torch.device("cpu")
WALL = {"value": "the row's wall, host clock"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def jax_sims(monkeypatch):
    """Every JAX ``LifecycleSim`` a row makes, in order."""
    made = []

    class Recording(jlifecycle.LifecycleSim):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jlifecycle, "LifecycleSim", Recording)
    return made


def digests_equal(jax_states, port_states) -> None:
    assert len(jax_states) == len(port_states)
    for js, ts in zip(jax_states, port_states):
        assert int(jtelemetry.tree_digest(js)) == int(ttelemetry.tree_digest(ts))


def test_loss1k(jax_sims):
    want = jsb.bench_loss1k(SEED, False)
    got = tsb.bench_loss1k(SEED, False, device=CPU)
    assert_rows_match(want, got, WALL)
    digests_equal([s.state for s in jax_sims], tsb.LAST_RUN["loss1k"]["states"])


def test_sweep100k(jax_sims):
    want = jsb.bench_sweep100k(SEED, False)
    got = tsb.bench_sweep100k(SEED, False, device=CPU)
    assert_rows_match(want, got, WALL)
    digests_equal([s.state for s in jax_sims], tsb.LAST_RUN["sweep100k"]["states"])


def test_partition_lc(jax_sims):
    want = jsb.bench_partition_lifecycle(SEED, False)
    got = tsb.bench_partition_lifecycle(SEED, False, device=CPU)
    assert_rows_match(want, got, {**WALL, "detect_s": "wall", "blip_s": "wall", "converge_s": "wall"})
    assert got["converge_extra_ticks"] > 0 and got["views_agree_after_blip"] is False
    digests_equal([s.state for s in jax_sims], tsb.LAST_RUN["partition_lc"]["states"])


def test_partition1m():
    want = jsb.bench_partition1m(SEED, False)
    got = tsb.bench_partition1m(SEED, False, device=CPU)
    assert_rows_match(want, got, WALL)


def test_ring1m_and_its_owners():
    want = jsb.bench_ring1m(SEED, False)
    got = tsb.bench_ring1m(SEED, False, device=CPU)
    assert_rows_match(want, got, {"value": "lookups/s", "keyed_hash_lookup_qps": "lookups/s",
                                  "build_s": "wall", "churn_rebalance_s": "wall"})
    run = tsb.LAST_RUN["ring1m"]
    tokens, owners = run["tokens"].numpy(), run["owners"].numpy()

    def oracle(hashes):
        idx = np.searchsorted(tokens, hashes, side="left")
        return owners[np.where(idx == len(tokens), 0, idx)]

    assert np.array_equal(run["owners_batch"].numpy(), oracle(run["hashes"].numpy()))
    from ringpop_tpu_torch.hashing.farm import fingerprint32_batch

    mat, lens = run["keys"]
    assert np.array_equal(run["owners_keyed"].numpy(), oracle(fingerprint32_batch(mat, lens).astype(np.int64)))


@pytest.mark.parametrize("n,k", [(1, 64), (5, 64), (100, 40), (1000, 64), (3, 100), (64, 1)])
def test_packed_delta_init_equals_init_state(n, k):
    params = tdelta.DeltaParams(n=n, k=k, rng="counter")
    got = tsb._delta_init_packed(params, 7, CPU)
    want = tdelta.init_state(params, seed=7, device=CPU)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def delta16m_recipe_jax(n: int, seed: int):
    params = jdelta.DeltaParams(n=n, k=64, rng="counter")
    jinit = jax.jit(functools.partial(jdelta.init_state, params), static_argnames="seed")
    jdelta.run_until_converged(params, jinit(seed=seed), max_ticks=8)
    state, ticks, ok = jdelta.run_until_converged(params, jinit(seed=seed + 1), max_ticks=4096)
    return ticks, ok, int(jtelemetry.tree_digest(state))


def test_delta16m_recipe_at_100k():
    """``delta16m``'s recipe (warm-up from ``seed``, the timed run from
    ``seed + 1``, 64 rumor slots, counter) at 100,000 nodes: the tick count,
    the verdict and the final state's digest."""
    n = 100_000
    params = tdelta.DeltaParams(n=n, k=64, rng="counter")
    tdelta.run_until_converged(params, tsb._delta_init_packed(params, SEED, CPU), max_ticks=8)
    state, ticks, ok = tdelta.run_until_converged(params, tsb._delta_init_packed(params, SEED + 1, CPU),
                                                  max_ticks=4096)
    assert (ticks, ok, int(ttelemetry.tree_digest(state))) == delta16m_recipe_jax(n, SEED)
    assert ok


@pytest.mark.slow
def test_delta16m(monkeypatch):
    states = []
    real = jdelta.run_until_converged

    def recording(*a, **kw):
        out = real(*a, **kw)
        states.append(out[0])
        return out

    monkeypatch.setattr(jdelta, "run_until_converged", recording)
    want = jsb.bench_delta16m(SEED, False)
    got = tsb.bench_delta16m(SEED, False, device=CPU)
    assert_rows_match(want, got, WALL)
    digests_equal(states[-1:], tsb.LAST_RUN["delta16m"]["states"])
