"""Both engines on (P, R) meshes of gloo ranks (the rumor axis: each rank
holds node rows block p and word block r of the packed planes), against
the JAX package run unsharded, bit for bit.

One spawned group a mesh shape, (1, 2), (2, 2) and (4, 2), runs every case
of that shape (``tests/torch_dist_worker.py``).  Each run is 24 ticks at
n 256, k 64 (two words: one a rumor rank), the lifecycle's with
``suspect_ticks`` 5 and a heal rate of 0.3 so the heal pair's rows cross
ranks: the delta and the lifecycle engine at the counter stream (the
shift exchange with six nodes down and 1 % loss), at threefry, and under
the uniform exchange.  Every leaf gathered from the ranks
(``partition.host_gather``) must equal the JAX package's at every tick
(sha256 of each leaf in the JAX dtypes); so must the digest combined from
the ranks (``tree_digest`` over a mesh), the delta's ``converged`` and
``run_until_converged``, and the lifecycle's view checksums,
``checksums_converged``, ``detection_complete`` and its detect path under
each ``learned_sharding`` route followed by the converge loop.  The
wrappers (``DeltaSim``'s journal, ``LifecycleSim``'s run-until pair and
``admit``) must equal the unsharded port's.  A k that does not shard over
the rumor axis raises the JAX package's ValueError.  Telemetry under a
mesh is in ``tests/test_torch_rumor_axis_telemetry.py`` and the chaos
twin's plans in ``tests/test_torch_rumor_axis_chaos.py``.
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import delta as jd, lifecycle as jl, telemetry as jt
from ringpop_tpu.sim.packbits import check_rumor_shardable as jcheck_rumor_shardable

from ringpop_tpu_torch.sim import delta as td, lifecycle as tl

from test_torch_sharded import DOWN, assert_leaves, jax_faults, jax_params, port_faults, spec
from torch_dist_worker import run_group

MESHES = ((1, 2), (2, 2), (4, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RUNS = {
    "delta_counter": spec("delta", 256, loop=True, every_tick=True),
    "delta_threefry": spec("delta", 256, rng="threefry", every_tick=True),
    "delta_uniform": spec("delta", 256, exchange="uniform", every_tick=True),
    "life_counter": spec("lifecycle", 256, detect=True, every_tick=True),
    "life_threefry": spec("lifecycle", 256, rng="threefry", every_tick=True),
    "life_uniform": spec("lifecycle", 256, exchange="uniform", every_tick=True),
}
# the (4, 2) group takes the counter runs only (8 ranks on the test box)
MESH_RUNS = {(1, 2): tuple(RUNS), (2, 2): tuple(RUNS), (4, 2): ("delta_counter", "life_counter")}
SIMS = {"delta_sim": spec("delta", 256), "life_sim": spec("lifecycle", 256)}
CHECKS = {"n": 256, "k": 64, "bad_k": 96}


@functools.lru_cache(maxsize=None)
def group(shape):
    jobs = [(name, "engine_run", RUNS[name]) for name in MESH_RUNS[shape]]
    jobs.append(("checks", "axis_checks", CHECKS))
    if shape == (2, 2):
        jobs += [(name, "sim_run", s) for name, s in SIMS.items()]
    return run_group(shape[0] * shape[1], jobs, shape=shape)


# -- the JAX side, unsharded -----------------------------------------------------


def leaf_hashes(state) -> list:
    return [hashlib.sha256(np.ascontiguousarray(np.asarray(x)).tobytes()).hexdigest() for x in state]


@functools.lru_cache(maxsize=None)
def jax_trace(name):
    """(final state, every tick's leaf hashes from tick 0) of the JAX run."""
    s = RUNS[name]
    params, faults = jax_params(s), jax_faults(s)
    engine = jd if s["engine"] == "delta" else jl
    state = engine.init_state(params, seed=s["seed"])
    fn = jax.jit(functools.partial(engine.step, params))
    hashes = [leaf_hashes(state)]
    for _ in range(s["ticks"]):
        state = fn(state, faults)
        hashes.append(leaf_hashes(state))
    return state, hashes


def engine_of(name):
    return (td, jd) if RUNS[name]["engine"] == "delta" else (tl, jl)


CASES = [(name, shape) for shape in MESHES for name in MESH_RUNS[shape]]


@pytest.mark.parametrize("name,shape", CASES)
def test_every_tick_equals_jax_unsharded(name, shape):
    got = group(shape)[name]
    js, want = jax_trace(name)
    port, _ = engine_of(name)
    fields = port.LifecycleState._fields if port is tl else port.DeltaState._fields
    assert len(got["tick_hashes"]) == len(want)
    for tick, (g, w) in enumerate(zip(got["tick_hashes"], want)):
        bad = [f for f, a, b in zip(fields, g, w) if a != b]
        assert not bad, f"{name} on {shape}: tick {tick} leaves {bad} differ from JAX unsharded"
    assert_leaves(got["leaves"], js, fields, port._LEAF_DTYPES, f"{name} on {shape}")


@pytest.mark.parametrize("name,shape", CASES)
def test_queries_and_digest_span_the_mesh(name, shape):
    got = group(shape)[name]
    js, _ = jax_trace(name)
    s = RUNS[name]
    jf = jax_faults(s)
    assert got["digest"] == int(jt.tree_digest(js))
    if s["engine"] == "delta":
        assert got["converged"] == bool(jd.converged(js, jf))
        whole = td.state_from_numpy(js, device="cpu")
        assert got["fraction"] == float(td.converged_fraction(whole, port_faults(s)))
        return
    assert np.array_equal(got["views"], np.asarray(jl.view_checksums(js, jf)).astype(np.int64))
    assert got["views_converged"] == bool(jl.checksums_converged(js, jf))
    assert got["detected_now"] == bool(jl.detection_complete(js, jnp.asarray(DOWN, jnp.int32), jf))


@functools.lru_cache(maxsize=None)
def _jax_loops():
    s = RUNS["delta_counter"]
    run = jd.run_until_converged(jax_params(s), jax_trace("delta_counter")[0], jax_faults(s), max_ticks=64,
                                 check_every=8)
    s = RUNS["life_counter"]
    params, faults = jax_params(s), jax_faults(s)
    state, blocks, done = jl._run_until_detected_device(
        params, jl.init_state(params, seed=s["seed"]), faults, jnp.asarray(DOWN, jnp.int32),
        min_status=jl.FAULTY, block_ticks=8, max_blocks=jnp.int32(8))
    conv = jl._run_until_converged_device(params, state, faults, block_ticks=8, max_blocks=jnp.int32(8))
    return run, (int(blocks), bool(done), state), (int(conv[1]), bool(conv[2]), conv[0])


@pytest.mark.parametrize("shape", MESHES)
def test_run_loops_span_the_mesh(shape):
    """The delta's ``run_until_converged`` and the lifecycle's detect path
    (every ``learned_sharding`` route) and converge loop: ticks, blocks,
    verdicts and leaves equal JAX's."""
    (js, jticks, jdone), (dblocks, ddone, dstate), (cblocks, cdone, cstate) = _jax_loops()
    got = group(shape)
    ticks, done, leaves = got["delta_counter"]["run"]
    assert (ticks, done) == (jticks, jdone)
    assert_leaves(leaves, js, td.DeltaState._fields, td._LEAF_DTYPES, f"run_until_converged on {shape}")
    assert ddone and dblocks > 0
    for route, (blocks, done, leaves) in got["life_counter"]["detect"].items():
        assert (blocks, done) == (dblocks, ddone), route
        assert_leaves(leaves, dstate, tl.LifecycleState._fields, tl._LEAF_DTYPES, f"detect ({route}) on {shape}")
    blocks, done, leaves = got["life_counter"]["converge"]
    assert (blocks, done) == (cblocks, cdone)
    assert_leaves(leaves, cstate, tl.LifecycleState._fields, tl._LEAF_DTYPES, f"converge loop on {shape}")


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_placement_and_refusal(shape):
    """The mesh's shape and coordinates (rank p·R + r at (p, r)), the one
    ``make_multihost_mesh(rumor_shards=R)`` builds, ``shard_put`` of a
    whole state == the engines' own blocks and ``host_gather`` its
    inverse, and k = 96 over R = 2 refused with the JAX package's
    ValueError by both engines."""
    got = group(shape)["checks"]
    assert got["shape"] == {"node": shape[0], "rumor": shape[1]} and got["coords"] == {"node": 0, "rumor": 0}
    assert got["multihost"] == (got["shape"], got["coords"])
    assert got["ringpop_tpu_torch.sim.delta"] and got["ringpop_tpu_torch.sim.lifecycle"]
    assert got["ringpop_tpu_torch.sim.delta_gather"] and got["ringpop_tpu_torch.sim.lifecycle_gather"]
    with pytest.raises(ValueError) as want:
        jcheck_rumor_shardable(CHECKS["bad_k"], shape[1])
    assert got["errors"] == {"delta": str(want.value), "lifecycle": str(want.value)}


def test_wrappers_on_a_2x2_mesh():
    """``DeltaSim``'s journal and ``LifecycleSim``'s run-until pair and
    ``admit`` on the (2, 2) ranks' blocks equal the unsharded port's."""
    got = group((2, 2))
    s = SIMS["delta_sim"]
    records = []
    sim = td.DeltaSim(256, 64, seed=s["seed"], rng="counter", telemetry_sink=records.append, device="cpu")
    assert got["delta_sim"]["result"] == sim.run_until_converged(port_faults(s), max_ticks=64, journal_every=16)
    assert got["delta_sim"]["records"] == [{k: (v.item() if isinstance(v, torch.Tensor) else v)
                                           for k, v in r.items()} for r in records]
    for name, g in zip(td.DeltaState._fields, got["delta_sim"]["leaves"]):
        assert np.array_equal(g, getattr(sim.state, name).numpy()), name
    s = SIMS["life_sim"]
    sim = tl.LifecycleSim(256, k=64, seed=s["seed"], rng="counter", suspect_ticks=5, device="cpu")
    faults = port_faults(s)
    assert got["life_sim"]["result"] == sim.run_until_detected(DOWN, faults, check_every=8)
    assert got["life_sim"]["converge"] == sim.run_until_converged(faults, check_every=8)
    state = tl.admit(sim.params, sim.state, DOWN[0])
    for name, g in zip(tl.LifecycleState._fields, got["life_sim"]["leaves"]):
        assert np.array_equal(g, getattr(state, name).numpy()), name
