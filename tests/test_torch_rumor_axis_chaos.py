"""simbench's chaos twin on a (2, 2) mesh, and ``chip_smoke.py``'s
``PIN_CHAOS_TWIN`` recomputed from the JAX package.

simbench certifies its chaos scenarios partition-invariant with a twin
(``_chaos_sharded_twin``): the lifecycle engine at 4096 x 64, counter
stream, ``suspect_ticks`` 6, 24 ticks of a plan built at horizon 64 (seed
0), unsharded and on its 4 x 2 mesh, every leaf compared.  Its four plans
are ``chaos.scenario_plan``'s churn, flap and asym and
``topology.topo_scenario_plan``'s smoke.  Here the JAX package runs each
plan unsharded on the CPU: its tree digest and leaf hashes must equal the
pins phase 18b holds the card to, and the port's run on a (2, 2) mesh of
gloo ranks (the chip runs simbench's own 4 x 2) must equal it leaf for
leaf, with the digest combined from the ranks.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.sim import chaos as jc, lifecycle as jl, telemetry as jt, topology as jtop

from ringpop_tpu_torch.sim import lifecycle as tl

from torch_dist_worker import run_group

PLANS = dict(chip_smoke.TWIN_PLANS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def twin_spec(name):
    return {"engine": "lifecycle", "n": chip_smoke.TWIN_N, "k": chip_smoke.TWIN_K, "rng": "counter",
            "exchange": "shift", "seed": chip_smoke.TWIN_SEED, "ticks": chip_smoke.TWIN_TICKS, "plan": name,
            "builder": PLANS[name], "horizon": chip_smoke.TWIN_HORIZON,
            "suspect_ticks": chip_smoke.TWIN_SUSPECT_TICKS, "heal_prob": jl.LifecycleParams(n=1).heal_prob,
            "down": [0]}


@functools.lru_cache(maxsize=None)
def jax_twin(name):
    """The JAX package's twin run of one plan, unsharded, as simbench's
    child takes it: its tree digest and leaf hashes."""
    build = jtop.topo_scenario_plan if PLANS[name] == "topo" else jc.scenario_plan
    plan = build(name, chip_smoke.TWIN_N, seed=chip_smoke.TWIN_SEED, horizon=chip_smoke.TWIN_HORIZON)
    params = jl.LifecycleParams(n=chip_smoke.TWIN_N, k=chip_smoke.TWIN_K,
                                suspect_ticks=chip_smoke.TWIN_SUSPECT_TICKS, rng="counter")
    blk = jax.jit(functools.partial(jl._run_block, params), static_argnames="ticks")
    state = blk(jl.init_state(params, seed=chip_smoke.TWIN_SEED), plan, ticks=chip_smoke.TWIN_TICKS)
    return {"digest": int(jt.tree_digest(state)), "leaves": chip_smoke.leaf_digests(state, jl.LifecycleState._fields)}


@functools.lru_cache(maxsize=None)
def group():
    return run_group(4, [(name, "engine_run", twin_spec(name)) for name in PLANS], shape=(2, 2))


@pytest.mark.parametrize("name", list(PLANS))
def test_chaos_twin_pins_match_the_jax_package(name):
    assert jax_twin(name) == chip_smoke.PIN_CHAOS_TWIN[name]


@pytest.mark.parametrize("name", list(PLANS))
def test_chaos_twin_on_a_2x2_mesh_equals_jax_unsharded(name):
    got = group()[name]
    whole = tl.LifecycleState(*(torch.from_numpy(np.ascontiguousarray(x)) for x in got["leaves"]))
    leaves = chip_smoke.leaf_digests(tl.state_to_numpy(whole), tl.LifecycleState._fields)
    want = jax_twin(name)
    bad = [leaf for leaf in leaves if leaves[leaf] != want["leaves"][leaf]]
    assert not bad, f"{name}: leaves {bad} differ from the JAX package's unsharded run"
    assert got["digest"] == want["digest"]
    # the plan did something by tick 24: slots in flight or nodes out of the base view
    assert int((whole.r_subject >= 0).sum()) > 0 or not bool(whole.base_present.all())
