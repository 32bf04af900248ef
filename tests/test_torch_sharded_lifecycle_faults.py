"""The lifecycle engine sharded over node ranks under the uniform exchange
(its packed planes gathered whole each tick) and under a
``chaos.scenario_plan``, against the JAX package, bit for bit: every leaf
gathered from P = 1, 2 and 4 gloo ranks equals the JAX package's run
unsharded and on a (P, 1) mesh, and so do the combined digest, the view
checksums, ``checksums_converged`` and ``detection_complete``.  The shift
exchange's runs, the detect path and ``LifecycleSim`` are in
``tests/test_torch_sharded_lifecycle.py``.
"""

import functools

import pytest
import torch

from test_torch_sharded import RANKS, spec
from test_torch_sharded_lifecycle import check_leaves_sharded, check_leaves_unsharded, check_queries
from torch_dist_worker import run_group

LIFE_RUNS = {
    "uniform": spec("lifecycle", 256, exchange="uniform"),
    "chaos": spec("lifecycle", 256, plan="smoke"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def group(p):
    return run_group(p, [(name, "engine_run", s) for name, s in LIFE_RUNS.items()])


CASES = [(name, p) for name in LIFE_RUNS for p in RANKS]


@pytest.mark.parametrize("name,p", CASES)
def test_leaves_equal_jax_unsharded(name, p):
    check_leaves_unsharded(group(p)[name], name, LIFE_RUNS[name], p)


@pytest.mark.parametrize("name,p", [(name, p) for name, p in CASES if p > 1])
def test_leaves_equal_jax_sharded(name, p):
    check_leaves_sharded(group(p)[name], name, LIFE_RUNS[name], p)


@pytest.mark.parametrize("name,p", CASES)
def test_queries_and_digest_span_the_ranks(name, p):
    check_queries(group(p)[name], name, LIFE_RUNS[name])
