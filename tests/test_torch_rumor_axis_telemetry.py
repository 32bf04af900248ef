"""Telemetry under a mesh: ``LifecycleSim(telemetry=..., exchange_mesh=...)``
on (2, 1) and (2, 2) meshes of gloo ranks, its journal records against the
JAX package's run unsharded, every field exact.

The accumulators are the rank's block (the per-node counters its rows, the
``piggybacked`` and ``expired`` planes its rows of its word block) and
``telemetry.fetch`` gathers them, with the census vectors, over both axes
before it reduces them in the JAX package's float32 order; the journal's
``state_digest`` is the digest combined from the ranks and ``views_sum``
the wrapped sum of the gathered view checksums.  Three recipes, each on
both meshes:

* ``down`` — n 256, k 64, six nodes down and 1 % loss at the counter
  stream, ``journal_views``: three 8-tick blocks, then
  ``run_until_detected``, then one more ``fetch_telemetry``;
* ``churn`` — ``chip_smoke.tel_chaos_run`` (simbench's ``churn100k``
  recipe: the churn plan, horizon 256 in 16-tick blocks, suspect_ticks 10)
  at n 1000, k 64, records and verdict (``chaos.score_blocks``);
* ``zone`` — the same recipe under ``topo_scenario_plan("zone_loss")`` at
  n 512, k 64 with the per-tier counters armed.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.sim import chaos as jc, lifecycle as jl, telemetry as jt, topology as jtop
from ringpop_tpu.sim.delta import DeltaFaults as JFaults

from ringpop_tpu_torch.sim import lifecycle as tl

from test_torch_chip_smoke_pins_telemetry import jax_chaos
from test_torch_sharded import DOWN, assert_leaves, spec
from torch_dist_worker import run_group

MESHES = ((2, 1), (2, 2))
FIELDS, DTYPES = tl.LifecycleState._fields, tl._LEAF_DTYPES

DOWN_RUN = spec("lifecycle", 256, blocks=3, block=8)
CHAOS_RUNS = {
    "churn": {"n": 1000, "k": 64, "seed": chip_smoke.TEL_SEED, "ticks": chip_smoke.TEL_HORIZON, "plan": "churn",
              "scenario": "churn-small"},
    "zone": {"n": 512, "k": 64, "seed": chip_smoke.TEL_SEED, "ticks": chip_smoke.TEL_HORIZON, "plan": "zone_loss",
             "builder": "topo", "scenario": "zone-small", "tiers": True},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def group(shape):
    jobs = [("down", "telemetry_run", DOWN_RUN)] + [(name, "tel_chaos", s) for name, s in CHAOS_RUNS.items()]
    return run_group(shape[0] * shape[1], jobs, shape=shape)


@functools.lru_cache(maxsize=None)
def jax_down():
    s = DOWN_RUN
    up = np.ones(s["n"], bool)
    up[DOWN] = False
    faults = JFaults(up=jnp.asarray(up), drop_rate=jnp.float32(s["drop"]))
    sink = jt.TelemetrySink()
    sim = jl.LifecycleSim(s["n"], k=s["k"], seed=s["seed"], rng=s["rng"], suspect_ticks=s["suspect_ticks"],
                          exchange=s["exchange"], heal_prob=s["heal_prob"], telemetry=sink, journal_views=True)
    for _ in range(s["blocks"]):
        sim.run(s["block"], faults)
    detect = sim.run_until_detected(DOWN, faults, check_every=8)
    return {"records": sink.records, "detect": detect, "fetched": sim.fetch_telemetry(faults)}, sim.state


@functools.lru_cache(maxsize=None)
def jax_recipe(name):
    s = CHAOS_RUNS[name]
    if s.get("builder") == "topo":
        plan = jtop.topo_scenario_plan(s["plan"], s["n"], seed=s["seed"], horizon=s["ticks"])
    else:
        plan = jc.scenario_plan(s["plan"], s["n"], seed=s["seed"], horizon=s["ticks"])
    return jax_chaos(plan, s["n"], s["k"], s["scenario"], tiers=s.get("tiers", False))


@pytest.mark.parametrize("shape", MESHES)
def test_down_records_equal_jax_unsharded(shape):
    got = group(shape)["down"]
    want, jstate = jax_down()
    assert got["records"] == want["records"]
    assert tuple(got["detect"]) == tuple(want["detect"]) and want["detect"][1]
    assert got["fetched"] == want["fetched"]
    assert_leaves(got["leaves"], jstate, FIELDS, DTYPES, f"telemetry run on {shape}")
    assert len(want["records"]) >= 4 and want["records"][0]["rumors_piggybacked"] > 0


@pytest.mark.parametrize("name,shape", [(name, shape) for shape in MESHES for name in CHAOS_RUNS])
def test_chaos_recipe_records_equal_jax_unsharded(name, shape):
    got = group(shape)[name]
    want = jax_recipe(name)
    assert got["records"] == want["records"]
    assert got["score"] == want["score"]
    assert want["score"]["suspects_declared"] > 0
