"""The delta engine at ``bench.py``'s full delta configuration: PyTorch port
against the JAX package.

1,000,000 x 128, ``exchange="shift"``, ``rng="counter"``, from seed 1: every
leaf of the port's ``DeltaState`` equals ``ringpop_tpu.sim.delta``'s at each
of the 16 ticks it takes to converge, on the CPU.  Apart from
``tests/test_torch_delta.py`` so that the one full-scale run is a unit of
its own for the test scheduler.  The tolerance is none.
"""

import pytest
import torch

from ringpop_tpu.sim import delta as jd

from ringpop_tpu_torch.sim import delta as td
from test_torch_delta import _pair, _run_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_full_scale_shift_matches_jax():
    """bench.py's delta configuration, 1,000,000 x 128 from seed 1: all
    leaves equal at each of the 16 ticks it takes the JAX package to
    converge, and both report convergence there."""
    jp, tp = _pair(1_000_000, 128, "shift")
    js, ts = _run_both(jp, tp, jd.DeltaFaults(), td.DeltaFaults(), 16)
    assert bool(jd.converged(js)) and bool(td.converged(ts))
    assert float(td.converged_fraction(ts)) == 1.0
