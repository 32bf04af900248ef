"""The fleet's process-sliced sweep and its multi-process checkpoints
(``FleetSweep(global_b=)``, the store behind ``save_carry_orbax``) against
the JAX package's ``FleetSweep`` run unbroken and unsharded, bit for bit.

The JAX fleet tests' grid (n 128, k 16, ``suspect_ticks`` 6, counter,
doses [0, 4] x losses (0, 0.1): B = 4), horizon 48 in 16-tick blocks:

* a sweep sliced over P = 2 processes (each its ``process_block``) saves
  at tick 16, each process writing only its rows, and runs on: its digests
  and scores equal the JAX sweep's unbroken run;
* that checkpoint restores at P = 1 (here) and at P = 4 (each process
  reading only its new slice's rows): digests and scores equal again;
* a checkpoint saved unsharded restores onto a (2, 2, 1) fleet mesh,
  which saves again at tick 32 (each rank its blocks), and that checkpoint
  restores at P = 1;
* the JAX package's refusals hold (a wrong config, an off-boundary target,
  a mesh on a slice), and a carry with None legs round-trips.

Two spawned groups: the P = 2 save, then one P = 4 group for both
restores and the mesh's save.
"""

import functools
import os
import shutil

import numpy as np
import pytest
import torch

from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import scenarios as js
from ringpop_tpu_torch.sim import chaos as tc
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim import scenarios as ts
from ringpop_tpu_torch.sim import snapshot as tsnap
from ringpop_tpu_torch.sim import telemetry as tt
from ringpop_tpu_torch.sim.montecarlo import make_fleet_mesh

from torch_dist_worker import run_group

CPU = torch.device("cpu")
N, K = 128, 16
GRID = dict(n=N, k=K, suspect_ticks=6, victims=[3, 9], doses=[0, 4], losses=(0.0, 0.1), churn_seed=777, seed=0,
            horizon=48, journal_every=16, save_at=16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def params(module=tl, **kw):
    return module.LifecycleParams(**{"n": N, "k": K, "suspect_ticks": 6, "rng": "counter", **kw})


def grid(module, **kw):
    plan, meta = module.scenario_grid(N, victims=GRID["victims"], doses=GRID["doses"], losses=GRID["losses"],
                                      churn_seed=GRID["churn_seed"], **kw)
    return plan, meta, module.grid_seeds(meta, GRID["seed"])


def sweep(**kw):
    plan, meta, seeds = grid(ts, device=CPU)
    return ts.FleetSweep(params(), plan, meta, seeds, horizon=GRID["horizon"], journal_every=GRID["journal_every"],
                         scenario="fleet-test", device=CPU, **kw)


@functools.lru_cache(maxsize=None)
def jax_unbroken():
    plan, meta, seeds = grid(js)
    run = js.FleetSweep(params(jl), plan, meta, seeds, horizon=GRID["horizon"], journal_every=GRID["journal_every"],
                        scenario="fleet-test").run()
    return {"digests": run.digests(), "scores": run.scores()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The P = 2 save, the P = 1 restore here, an unsharded save here, the
    P = 4 group's two restores (its slices; the (2, 2, 1) mesh, saving at
    tick 32), and the mesh's save restored here."""
    root = tmp_path_factory.mktemp("fleet_ckpt")
    sliced, whole, meshed = str(root / "p2"), str(root / "p1"), str(root / "mesh")
    p2 = run_group(2, [("save", "fleet_sweep", dict(GRID, path=sliced))], every_rank=True)
    plan, meta, seeds = grid(ts, device=CPU)
    p1 = ts.FleetSweep.restore(sliced, params(), plan, meta, seeds, scenario="fleet-test", device=CPU).run()
    s = sweep()
    s.run(until_tick=GRID["save_at"])
    s.save(whole)
    p4 = run_group(4, [("slices", "fleet_restore", dict(GRID, path=sliced)),
                       ("mesh", "fleet_restore", dict(GRID, path=whole, shape=(2, 2, 1), size=4, resave=meshed,
                                                      resave_at=2 * GRID["save_at"]))], every_rank=True)
    from_mesh = ts.FleetSweep.restore(meshed, params(), plan, meta, seeds, scenario="fleet-test", device=CPU).run()
    return {"p2": [r["save"] for r in p2], "p1": p1, "p4": [r["slices"] for r in p4],
            "mesh": [r["mesh"] for r in p4], "sliced": sliced, "meshed": meshed, "from_mesh": from_mesh}


def merged(ranks) -> dict:
    digests, scores = {}, []
    for r in ranks:
        digests.update(r["digests"])
        scores += r["scores"]
    return {"digests": digests, "scores": sorted(scores, key=lambda s: s["scenario_id"])}


def test_sliced_sweep_saved_mid_sweep_equals_the_unbroken_jax_sweep(runs):
    assert merged(runs["p2"]) == jax_unbroken()
    assert [r["header"]["fleet_b"] for r in runs["p2"]] == [2, 2]
    assert {r["header"]["global_b"] for r in runs["p2"]} == {4}
    # each process wrote only its rows, and its own sidecar
    assert sorted(os.listdir(runs["sliced"])) == ["shard-00000.npz", "shard-00001.npz"]
    assert sorted(os.listdir(runs["sliced"] + ".meta")) == ["rank0.json", "rank1.json"]
    with np.load(os.path.join(runs["sliced"], "shard-00001.npz")) as data:
        assert data["states.learned"].shape[0] == 2


@pytest.mark.parametrize("where", ["p1", "p4"])
def test_restore_at_another_process_count_equals_jax(runs, where):
    if where == "p1":
        got = {"digests": runs["p1"].digests(), "scores": runs["p1"].scores()}
        resumed = runs["p1"].header_params()["resumed"]
        assert (resumed["saved_process_count"], resumed["restored_process_count"]) == (2, 1)
    else:
        got = merged(runs["p4"])
        assert {r["header"]["resumed"]["restored_process_count"] for r in runs["p4"]} == {4}
        assert [r["header"]["fleet_b"] for r in runs["p4"]] == [1, 1, 1, 1]
    assert got == jax_unbroken()


def test_unsharded_save_restores_onto_a_fleet_mesh(runs):
    want = jax_unbroken()
    for r in runs["mesh"]:
        assert r["digests"] == want["digests"] and r["scores"] == want["scores"]
        assert r["header"]["resumed"]["from_tick"] == GRID["save_at"]


def test_fleet_mesh_save_restores_at_one_process(runs):
    back = runs["from_mesh"]
    assert {"digests": back.digests(), "scores": back.scores()} == jax_unbroken()
    resumed = back.header_params()["resumed"]
    assert (resumed["from_tick"], resumed["saved_process_count"], resumed["restored_process_count"]) == (32, 4, 1)
    # every rank of the (2, 2, 1) mesh wrote its own (batch, node) blocks
    assert sorted(os.listdir(runs["meshed"])) == [f"shard-{r:05d}.npz" for r in range(4)]
    assert sorted(os.listdir(runs["meshed"] + ".meta")) == [f"rank{r}.json" for r in range(4)]


def test_refusals(tmp_path, runs):
    s = sweep()
    with pytest.raises(ValueError, match="block boundary"):
        s.run(until_tick=17)
    s.run(until_tick=16)
    ck = str(tmp_path / "ck")
    s.save(ck)
    plan, meta, seeds = grid(ts, device=CPU)
    with pytest.raises(ValueError, match="checkpoint was taken with"):
        ts.FleetSweep.restore(ck, params(suspect_ticks=7), plan, meta, seeds, device=CPU)
    with pytest.raises(ValueError, match="sidecars"):
        ts.FleetSweep.restore(str(tmp_path / "nope"), params(), plan, meta, seeds, device=CPU)
    with pytest.raises(ValueError, match="two partitioning owners"):
        ts.FleetSweep(params(), tc.slice_plan(plan, 0, 2), meta[:2], seeds[:2], horizon=48, global_b=4,
                      mesh=make_fleet_mesh(device="cpu"), device=CPU)
    # the P = 2 store with one process's file gone, or doubled, refuses
    bad = str(tmp_path / "bad")
    shutil.copytree(runs["sliced"], bad)
    shutil.copytree(runs["sliced"] + ".meta", bad + ".meta")
    shutil.copy(os.path.join(bad, "shard-00001.npz"), os.path.join(bad, "shard-00002.npz"))
    with pytest.raises(ValueError, match="overlapping blocks"):
        ts.FleetSweep.restore(bad, params(), plan, meta, seeds, device=CPU)
    os.remove(os.path.join(bad, "shard-00002.npz"))
    os.remove(os.path.join(bad, "shard-00001.npz"))
    with pytest.raises(ValueError, match="missing block"):
        ts.FleetSweep.restore(bad, params(), plan, meta, seeds, device=CPU)


def test_carry_with_none_legs_round_trips(tmp_path):
    tel = tt.zeros(tl.LifecycleParams(n=64, k=16), device=CPU)  # suspects_by_tier None: structure, not leaves
    carry = {"states": {"x": torch.arange(12, dtype=torch.int32).reshape(3, 4)}, "telemetry": tel,
             "first": torch.tensor([1, -1, 3], dtype=torch.int32)}
    path = str(tmp_path / "carry")
    tsnap.save_carry_orbax(path, carry)
    out = tsnap.load_carry_orbax(path, carry)
    assert isinstance(out["telemetry"], tt.TelemetryState) and out["telemetry"].suspects_by_tier is None
    flat_in, flat_out = tsnap._flatten_named(carry), tsnap._flatten_named(out)
    assert list(flat_in) == list(flat_out)
    for name, (leaf, _) in flat_in.items():
        assert torch.equal(flat_out[name][0], leaf), name
    with pytest.raises(ValueError, match="wrong fleet config"):
        tsnap.load_carry_orbax(path, dict(carry, first=torch.zeros(5, dtype=torch.int32)))
