"""The fleet's batch axis as a mesh axis (``montecarlo.make_fleet_mesh``,
``MonteCarlo(mesh=)``) on gloo ranks, against the JAX package's fleet run
unsharded, bit for bit.

One spawned group of 8 ranks builds the (2, 4, 1) mesh (its own) and the
(2, 2, 2) mesh, and the default (8, 1, 1) one: each rank holds its batch
block of the replicas, each over its batch group's (P, R) mesh.  On the
JAX tests' grid (n 128, k 16, ``suspect_ticks`` 6, counter, doses [0, 4] x
losses (0, 0.1): B = 4; k 64 for the rumor axis) the per-scenario records
and digests after ``run`` must equal the JAX ``MonteCarlo``'s, and so must
``run_until_detected``'s ticks, flags, records and every final leaf (the
JAX package's ``test_sharded_detection_loop_equal``); every rank gets
every record.  The shardings' specs are checked on a mesh built without
ranks.
"""

import functools

import numpy as np
import pytest
import torch

from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import montecarlo as jm
from ringpop_tpu.sim import scenarios as js
from ringpop_tpu_torch.parallel.mesh import FleetMesh, Mesh
from ringpop_tpu_torch.parallel.partition import P
from ringpop_tpu_torch.sim import chaos as tc
from ringpop_tpu_torch.sim import montecarlo as tm
from ringpop_tpu_torch.sim import scenarios as ts

from torch_dist_worker import run_group

N = 128
VICTIMS = sorted(np.random.default_rng(0).choice(N, size=2, replace=False).tolist())
BASE = dict(n=N, suspect_ticks=6, victims=VICTIMS, doses=[0, 4], losses=(0.0, 0.1), churn_seed=777, seed=0,
            ticks=24, size=8)
DETECT = dict(detect=True, max_ticks=256, check_every=4)
SPECS = {
    "b2_n4": dict(BASE, k=16, shape=None, **DETECT),
    "b2_n2_r2": dict(BASE, k=64, shape=(2, 2, 2), **DETECT),
    "b8": dict(BASE, k=16, shape=(8, 1, 1), doses=[0, 2, 4, 6], ticks=8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def group():
    """Every rank's results: the group's own mesh is (2, 4, 1)."""
    return run_group(8, [(name, "fleet_mc", spec) for name, spec in SPECS.items()], shape=(2, 4, 1), every_rank=True)


@functools.lru_cache(maxsize=None)
def jax_fleet(name):
    """The JAX fleet unsharded on a spec's grid: records after ``ticks``,
    and (with ``detect``) a fresh fleet's detection ticks, flags, records
    and final leaves."""
    spec = SPECS[name]
    params = jl.LifecycleParams(n=N, k=spec["k"], suspect_ticks=spec["suspect_ticks"], rng="counter")
    plan, meta = js.scenario_grid(N, victims=VICTIMS, doses=spec["doses"], losses=spec["losses"],
                                  churn_seed=spec["churn_seed"])
    seeds = js.grid_seeds(meta, spec["seed"])
    mc = jm.MonteCarlo(params, seeds, telemetry=True)
    mc.run(spec["ticks"], plan)
    out = {"records": mc.fetch_telemetry(plan)}
    if spec.get("detect"):
        mc = jm.MonteCarlo(params, seeds, telemetry=True)
        ticks, det = mc.run_until_detected(VICTIMS, plan, max_ticks=spec["max_ticks"],
                                           check_every=spec["check_every"])
        out.update(detect=([int(t) for t in ticks], [bool(d) for d in det]),
                   detect_records=mc.fetch_telemetry(plan), leaves=[np.asarray(x) for x in mc.states])
    return out


@pytest.mark.parametrize("name", list(SPECS))
def test_fleet_mesh_records_equal_jax_unsharded(name):
    want = jax_fleet(name)["records"]
    ranks = group()
    for r in ranks:
        assert r[name]["records"] == want, (name, r[name]["coords"])
    assert [rec["state_digest"] for rec in want] == ranks[0][name]["digests"]
    # each batch coordinate holds its block of the replicas, and no more
    b = len(want)
    bm = SPECS[name]["shape"][0] if SPECS[name]["shape"] else 2
    for r in ranks:
        lo, hi = r[name]["block"]
        assert (lo, hi) == (r[name]["coords"]["batch"] * b // bm, (r[name]["coords"]["batch"] + 1) * b // bm)
        assert r[name]["local"] == b // bm


@pytest.mark.parametrize("name", ["b2_n4", "b2_n2_r2"])
def test_fleet_mesh_detection_loop_equal(name):
    """``run_until_detected`` (telemetry on): equal ticks and flags, equal
    records after it and every final leaf equal."""
    want = jax_fleet(name)
    got = group()[0][name]
    assert got["detect"] == want["detect"]
    assert got["detect_records"] == want["detect_records"]
    for field, a, b in zip(jl.LifecycleState._fields, got["leaves"], want["leaves"]):
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_fleet_mesh_axes_carry_what_they_should():
    """The batch axis carries no collective inside a tick: one gather for
    the fetch's columns and one for the digests; the node and rumor axes
    carry the replicas' ticks."""
    ranks = group()
    for name in SPECS:
        stats = ranks[0][name]["axis_stats"]
        assert stats["batch"]["collectives"] == 2 and stats["batch"]["sends"] == 0, (name, stats)
    assert ranks[0]["b2_n4"]["axis_stats"]["node"]["collectives"] > 0
    assert ranks[0]["b2_n2_r2"]["axis_stats"]["rumor"]["collectives"] > 0
    assert ranks[0]["b8"]["axis_stats"]["node"]["collectives"] == 0
    assert [r["b2_n2_r2"]["coords"] for r in ranks[:4]] == [
        {"batch": 0, "node": p, "rumor": q} for p in (0, 1) for q in (0, 1)]


def fleet_mesh_at(shape, coords=(0, 0, 0)):
    """A fleet mesh's rank at ``coords`` without process groups: enough for
    shardings and placement, which need no collective."""
    dev = torch.device("cpu")
    return FleetMesh(batch=Mesh(size=shape[0], rank=coords[0], device=dev, transport="gloo"),
                     inner=Mesh(size=shape[1], rank=coords[1], device=dev, transport="gloo", rumor_size=shape[2],
                                rumor_rank=coords[2]))


def test_fleet_shardings_specs():
    mesh = fleet_mesh_at((2, 4, 1))
    fs = tm.fleet_state_shardings(mesh, k=32)
    assert fs.pcount.spec == P("batch", "node", "rumor") and fs.base_status.spec == P("batch", "node")
    assert fs.tick.spec == P("batch") and fs.r_subject.spec == P("batch", "rumor")
    with pytest.raises(ValueError):
        tm.fleet_state_shardings(fleet_mesh_at((2, 2, 2)), k=32)
    plan, _ = ts.scenario_grid(N, victims=VICTIMS, doses=[0, 4], losses=(0.0, 0.1), churn_seed=777, device="cpu")
    sh = tm.fleet_faults_shardings(plan, mesh)
    # stacked legs carry the batch prefix over their canonical spec, legs no
    # member set stay None
    assert sh.base_up.spec == P("batch", "node") and sh.drop_rate.spec == P("batch")
    assert (plan.reach is None) == (sh.reach is None)
    # a solo plan's legs keep the canonical placement, no batch prefix
    solo = tc.scenario_plan("churn", N, seed=0, horizon=64, device="cpu")
    assert tm.fleet_faults_shardings(solo, mesh).crash_tick.spec == P("node")
    # a (P, R) mesh: the batch replicated, every replica sharded
    plain = tm.fleet_state_shardings(Mesh(size=2, rank=0, device=torch.device("cpu"), transport="gloo"))
    assert plain.learned.spec == P(None, "node", "rumor")
    # the JAX package's specs on its own fleet mesh, for the same leaves
    jfs = jm.fleet_state_shardings(jm.make_fleet_mesh(8, (2, 4, 1)), k=32)
    for field in ("pcount", "base_status", "tick", "r_subject", "key"):
        assert tuple(getattr(jfs, field).spec) == tuple(getattr(fs, field).spec), field
