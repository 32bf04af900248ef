"""The lifecycle engine sharded over node ranks, against the JAX package,
bit for bit (the delta engine's runs, and the helpers, are in
``tests/test_torch_sharded.py``).

One spawned group of P gloo ranks (P = 1, 2 and 4) runs every case of the
module.  Each run is 24 ticks at n 256, k 64, ``suspect_ticks`` 5 and a
heal attempt rate of 0.3 (so the heal pair's rows cross ranks): the shift
exchange with six nodes down and 1 % loss at the counter stream, the same
at threefry, and with the sequential legs at H = 4 (the uniform exchange
and a ``chaos.scenario_plan`` are in
``tests/test_torch_sharded_lifecycle_faults.py``, so that the two files
can run on two test workers).  Every leaf gathered from the ranks
must equal the JAX package's run, unsharded and on a (P, 1) mesh; so must
the digest combined from the ranks' partial sums, ``view_checksums``
gathered from the observers' ranks, ``checksums_converged`` and
``detection_complete``.  The counter run also takes the detect path from
tick 0 under each ``learned_sharding`` route (partials, node-sharded hint,
the plane gathered whole) and then the converge loop: blocks, verdicts and
leaves equal JAX's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import lifecycle as jl, telemetry as jt

from ringpop_tpu_torch.sim import lifecycle as tl

from test_torch_sharded import DOWN, RANKS, assert_leaves, jax_faults, jax_params, jax_state, port_faults, spec
from torch_dist_worker import run_group

FIELDS, DTYPES = tl.LifecycleState._fields, tl._LEAF_DTYPES

LIFE_RUNS = {
    "counter": spec("lifecycle", 256, detect=True),
    "threefry": spec("lifecycle", 256, rng="threefry"),
    "sequential_h4": spec("lifecycle", 256, h=4, pipelined=False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def group(p):
    jobs = [(name, "engine_run", s) for name, s in LIFE_RUNS.items()]
    jobs.append(("sim", "sim_run", spec("lifecycle", 256)))
    return run_group(p, jobs)


CASES = [(name, p) for name in LIFE_RUNS for p in RANKS]


def check_leaves_unsharded(got, name, s, p):
    assert_leaves(got["leaves"], jax_state(("life", name), s), FIELDS, DTYPES,
                  f"{name} over {p} ranks vs JAX unsharded")


def check_leaves_sharded(got, name, s, p):
    assert_leaves(got["leaves"], jax_state(("life", name), s, p), FIELDS, DTYPES,
                  f"{name} over {p} ranks vs JAX on a ({p}, 1) mesh")


def check_queries(got, name, s):
    js = jax_state(("life", name), s)
    jf = jax_faults(s)
    assert got["digest"] == int(jt.tree_digest(js))
    assert np.array_equal(got["views"], np.asarray(jl.view_checksums(js, jf)).astype(np.int64))
    assert got["views_converged"] == bool(jl.checksums_converged(js, jf))
    assert got["detected_now"] == bool(jl.detection_complete(js, jnp.asarray(DOWN, jnp.int32), jf))


@pytest.mark.parametrize("name,p", CASES)
def test_leaves_equal_jax_unsharded(name, p):
    check_leaves_unsharded(group(p)[name], name, LIFE_RUNS[name], p)


@pytest.mark.parametrize("name,p", [(name, p) for name, p in CASES if p > 1])
def test_leaves_equal_jax_sharded(name, p):
    check_leaves_sharded(group(p)[name], name, LIFE_RUNS[name], p)


@pytest.mark.parametrize("name,p", CASES)
def test_queries_and_digest_span_the_ranks(name, p):
    check_queries(group(p)[name], name, LIFE_RUNS[name])


@functools.lru_cache(maxsize=None)
def _jax_detect():
    s = LIFE_RUNS["counter"]
    params, faults = jax_params(s), jax_faults(s)
    state, blocks, done = jl._run_until_detected_device(
        params, jl.init_state(params, seed=s["seed"]), faults, jnp.asarray(DOWN, jnp.int32),
        min_status=jl.FAULTY, block_ticks=8, max_blocks=jnp.int32(8))
    conv = jl._run_until_converged_device(params, state, faults, block_ticks=8, max_blocks=jnp.int32(8))
    return (int(blocks), bool(done), state), (int(conv[1]), bool(conv[2]), conv[0])


@pytest.mark.parametrize("p", RANKS)
def test_detect_path_under_each_learned_sharding_route(p):
    """Blocks, verdict and leaves of ``_run_until_detected_device`` equal
    JAX's whichever route the detection test takes, and so does the
    converge loop after it."""
    (jblocks, jdone, jstate), (cblocks, cdone, cstate) = _jax_detect()
    got = group(p)["counter"]
    assert jdone and jblocks > 0
    for route, (blocks, done, leaves) in got["detect"].items():
        assert (blocks, done) == (jblocks, jdone), route
        assert_leaves(leaves, jstate, FIELDS, DTYPES, f"detect path ({route}) over {p} ranks")
    blocks, done, leaves = got["converge"]
    assert (blocks, done) == (cblocks, cdone)
    assert_leaves(leaves, cstate, FIELDS, DTYPES, f"converge loop over {p} ranks")


@pytest.mark.parametrize("p", RANKS)
def test_lifecycle_sim_over_a_mesh(p):
    """``LifecycleSim(exchange_mesh=...)``'s run-until pair and ``admit`` on
    the ranks' blocks equal the unsharded port's."""
    s = spec("lifecycle", 256)
    got = group(p)["sim"]
    sim = tl.LifecycleSim(256, k=64, seed=s["seed"], rng="counter", suspect_ticks=5, device="cpu")
    faults = port_faults(s)
    assert got["result"] == sim.run_until_detected(DOWN, faults, check_every=8)
    assert got["converge"] == sim.run_until_converged(faults, check_every=8)
    state = tl.admit(sim.params, sim.state, DOWN[0])
    for name, g in zip(FIELDS, got["leaves"]):
        assert np.array_equal(g, getattr(state, name).numpy()), name
