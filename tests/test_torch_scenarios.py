"""The port's scenario-grid compiler and fleet sweeps
(``ringpop_tpu_torch/sim/scenarios.py``) against the JAX package's, bit
for bit, on the CPU.

* the grid compiler: every leg of the stacked plan and the meta table
  (churn × loss × partition × suspicion timeout × topology overlay), the
  dose ladder, masks and seeds;
* the scored sweep: ``scored_fleet``'s verdicts and block records, a
  ``FleetSweep`` saved mid-sweep (save does not perturb it), killed and
  restored (scores and digests equal the unbroken run's and the JAX
  sweep's), its stored carry leaf for leaf against the JAX sweep's carry,
  and the refusals (wrong config, off-boundary targets, a process slice
  that is not its process's block, a mesh on a slice, the A15 routes);
* the detection surfaces: ``detect_surface`` against ``sequential_detect``
  and the JAX package, ``refine_surface`` and ``dense_surface`` each
  against the JAX functions' live output on the same inputs (not against
  each other: on this toolchain the JAX pair disagrees at this size).

The JAX detection runs share one compiled program (same params, batch
width and plan structure) and the JAX sweep runs once (a module fixture).
"""

import json
import os

import numpy as np
import pytest
import torch

from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import scenarios as js
from ringpop_tpu.sim import snapshot as jsnap
from ringpop_tpu.sim import telemetry as jt
from ringpop_tpu.sim import topology as jtop
from ringpop_tpu_torch.parallel.mesh import Mesh
from ringpop_tpu_torch.parallel.partition import fleet_shard_put
from ringpop_tpu_torch.sim import chaos as tc
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim import scenarios as ts
from ringpop_tpu_torch.sim.montecarlo import make_fleet_mesh
from ringpop_tpu_torch.sim import telemetry as tt
from ringpop_tpu_torch.sim import topology as ttop

CPU = torch.device("cpu")
N = 64
FLEET = dict(n=N, k=16, suspect_ticks=6, rng="counter")
SURFACE = dict(n=N, k=8, suspect_ticks=6, rng="counter")
VICTIMS = [5, 42]
HORIZON, BLOCK = 32, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def plan_legs_np(plan) -> dict:
    return {f: (None if v is None else (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)))
            for f, v in zip(plan._fields, plan)}


def assert_plans_equal(port_plan, jax_plan):
    got, want = plan_legs_np(port_plan), plan_legs_np(jax_plan)
    for field, w in want.items():
        g = got[field]
        assert (g is None) == (w is None), field
        if w is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), field


def assert_records_equal(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, wv in w.items():
            assert type(g[key]) is type(wv) and g[key] == wv, (key, g[key], wv)


# -- the grid compiler -------------------------------------------------------------


def test_grid_plan_and_meta_match_jax():
    kw = dict(victims=[3, 9], doses=[0, 4], losses=(0.0, 0.1), parts=(0.0, 0.25), suspects=(None, 4),
              churn_seed=5, part_from=2, part_until=20)
    jzone = jtop.topo_scenario_plan("zone_loss", N, seed=0, horizon=32)
    tzone = ttop.topo_scenario_plan("zone_loss", N, seed=0, horizon=32, device=CPU)
    jplan, jmeta = js.scenario_grid(N, overlays=[("none", None), ("zone", jzone)], **kw)
    tplan, tmeta = ts.scenario_grid(N, overlays=[("none", None), ("zone", tzone)], device=CPU, **kw)
    assert tmeta == jmeta and len(tmeta) == 32
    assert_plans_equal(tplan, jplan)
    assert ts.grid_seeds(tmeta, 100) == js.grid_seeds(jmeta, 100)
    # the plain grid (no partition, timeout or overlay axis), never-healing splits
    for grid_kw in (dict(victims=[3], doses=[0, 2, 7], losses=(0.0, 0.02, 0.1), churn_seed=1),
                    dict(victims=[3], doses=[0], parts=(0.0, 0.5), churn_seed=1, part_until=None)):
        jp, jm_ = js.scenario_grid(N, **grid_kw)
        tp, tm_ = ts.scenario_grid(N, device=CPU, **grid_kw)
        assert tm_ == jm_
        assert_plans_equal(tp, jp)
    assert ts.mc_churn_doses(32, 128) == js.mc_churn_doses(32, 128)
    assert ts.mc_churn_doses(1, 5) == js.mc_churn_doses(1, 5)
    assert np.array_equal(ts.churn_dose_masks(N, [9, 3], [0, 5, 11], 77),
                          js.churn_dose_masks(N, [9, 3], [0, 5, 11], 77))
    assert np.array_equal(ts.dose_mask_table(N, [3], 12, 7), js.dose_mask_table(N, [3], 12, 7))
    assert ts.sweep_static([4, 2], lambda v: v * 10) == {4: 40, 2: 20}


def test_response_surface_and_cliff_match_jax():
    meta = [{"churn": c, "loss": l} for l in (0.0, 0.1) for c in (0, 10, 20)]
    values = [10, 11, 40, 12, None, 44]
    assert ts.response_surface(meta, values) == js.response_surface(meta, values)
    assert ts.response_surface(meta, values, rows="churn", cols="loss") == js.response_surface(
        meta, values, rows="churn", cols="loss")
    for curve in ([], [(5, 12)], [(0, None), (1, 5)], [(0, 10), (1, 10)], [(0, 30), (1, 20)], [(4, 10), (5, 40)],
                  [(0, 0), (1, 10), (2, 20)]):
        assert ts.locate_cliff(curve) == js.locate_cliff(curve)


# -- the scored sweep ----------------------------------------------------------------


def fleet_grid(module, **kw):
    plan, meta = module.scenario_grid(N, victims=[3, 9], doses=[0, 4], losses=(0.0, 0.1), churn_seed=777, **kw)
    return plan, meta, module.grid_seeds(meta, 0)


@pytest.fixture(scope="module")
def jax_sweep():
    """The JAX sweep once: its carry at the mid-sweep checkpoint, then its
    block records, verdicts and digests at the horizon."""
    plan, meta, seeds = fleet_grid(js)
    sink = jt.TelemetrySink()
    sweep = js.FleetSweep(jl.LifecycleParams(**FLEET), plan, meta, seeds, horizon=HORIZON, journal_every=BLOCK,
                          sink=sink, scenario="fleet-test")
    sweep.run(until_tick=BLOCK)
    carry = {name: np.asarray(leaf) for name, leaf in jsnap._flatten_named(sweep._carry()).items()}
    sweep.run()
    # the digests at the horizon, as the last block's records carry them
    # (the same vmapped tree_digest as FleetSweep.digests, in its program)
    digests = {rec["scenario_id"]: rec["state_digest"] for rec in sink.records[-len(meta):]}
    return {"carry": carry, "records": sink.records, "scores": sweep.scores(), "digests": digests}


def port_sweep(**kw):
    plan, meta, seeds = fleet_grid(ts, device=CPU)
    return ts.FleetSweep(tl.LifecycleParams(**FLEET), plan, meta, seeds, horizon=HORIZON, journal_every=BLOCK,
                         scenario="fleet-test", device=CPU, **kw)


def test_scored_fleet_matches_jax(jax_sweep):
    plan, meta, seeds = fleet_grid(ts, device=CPU)
    sink = tt.TelemetrySink()
    scores = ts.scored_fleet(tl.LifecycleParams(**FLEET), plan, meta, seeds, horizon=HORIZON, journal_every=BLOCK,
                             sink=sink, scenario="fleet-test", device=CPU)
    assert scores == jax_sweep["scores"]
    assert_records_equal(sink.records, jax_sweep["records"])
    assert [s["blocks"] for s in scores] == [HORIZON // BLOCK] * 4
    assert [(s["churn"], s["loss"]) for s in scores] == [(m["churn"], m["loss"]) for m in meta]
    assert sum(s["suspects_declared"] for s in scores) > 0


def test_fleet_sweep_save_kill_restore_matches_unbroken_and_jax(jax_sweep, tmp_path):
    ck = str(tmp_path / "ck")
    sweep = port_sweep()
    sweep.run(until_tick=BLOCK)
    sweep.save(ck)
    # the port's carry, read with numpy (the store's one file: a single
    # process writes every leaf whole), is the JAX sweep's carry leaf for leaf
    with np.load(os.path.join(ck, "shard-00000.npz")) as data:
        assert sorted(f for f in data.files if f != "__index__") == sorted(jax_sweep["carry"])
        for name, want in jax_sweep["carry"].items():
            assert data[name].dtype == want.dtype and np.array_equal(data[name], want), name
    with open(ck + ".meta/rank0.json") as f:
        side = json.load(f)
    assert side["version"] == ts.FLEET_CKPT_VERSION and side["ticks_done"] == BLOCK and side["process_count"] == 1
    # saving is observation: the sweep runs on to the unbroken result
    sweep.run()
    assert sweep.digests() == jax_sweep["digests"]
    assert sweep.scores() == jax_sweep["scores"]
    del sweep
    plan, meta, seeds = fleet_grid(ts, device=CPU)
    resumed = ts.FleetSweep.restore(ck, tl.LifecycleParams(**FLEET), plan, meta, seeds, device=CPU)
    assert resumed.ticks_done == BLOCK and resumed.resumed["from_tick"] == BLOCK
    assert resumed.mc.telemetry.ticks.tolist() == [0] * 4  # the carry holds the reset accumulators
    resumed.run()
    assert resumed.digests() == jax_sweep["digests"]
    assert resumed.scores() == jax_sweep["scores"]
    hp = resumed.header_params()
    assert hp["ticks_done"] == HORIZON and hp["resumed"]["restored_process_count"] == 1
    assert hp["resumed"]["checkpoint"] == os.path.abspath(ck)


def test_fleet_sweep_refusals(tmp_path, monkeypatch):
    plan, meta, seeds = fleet_grid(ts, device=CPU)
    params = tl.LifecycleParams(**FLEET)
    sweep = port_sweep()
    with pytest.raises(ValueError, match="block boundary"):
        sweep.run(until_tick=BLOCK + 1)
    ck = str(tmp_path / "ck")
    sweep.save(ck)
    wrong = tl.LifecycleParams(**{**FLEET, "suspect_ticks": 7})
    with pytest.raises(ValueError, match="checkpoint was taken with"):
        ts.FleetSweep.restore(ck, wrong, plan, meta, seeds, device=CPU)
    with pytest.raises(ValueError, match="sidecars"):
        ts.FleetSweep.restore(str(tmp_path / "nope"), params, plan, meta, seeds, device=CPU)
    with pytest.raises(ValueError, match="B=4 fleet, restore sliced B=2"):
        ts.FleetSweep.restore(ck, params, tc.slice_plan(plan, 0, 2), meta[:2], seeds[:2], device=CPU)
    # a carry of another shape: the per-tier counters are not in the checkpoint
    with pytest.raises(ValueError, match="wrong fleet config"):
        ts.FleetSweep.restore(ck, params, plan, meta, seeds, telemetry_tiers=True, device=CPU)
    side = ck + ".meta/rank0.json"
    with open(side) as f:
        head = json.load(f)
    with open(side, "w") as f:
        json.dump({**head, "version": 99}, f)
    with pytest.raises(ValueError, match="version 99"):
        ts.FleetSweep.restore(ck, params, plan, meta, seeds, device=CPU)
    # a checkpoint another process count wrote restores here (the store's
    # rows are where they are, whoever wrote them)
    with open(side, "w") as f:
        json.dump({**head, "process_count": 2}, f)
    back = ts.FleetSweep.restore(ck, params, plan, meta, seeds, device=CPU)
    assert back.resumed["saved_process_count"] == 2 and back.resumed["restored_process_count"] == 1
    # a process slice must be its process's block of the grid to save: one
    # process's block is the whole grid
    part = ts.FleetSweep(params, plan, meta, seeds, horizon=HORIZON, global_b=8, device=CPU)
    assert part.sliced and part.header_params()["global_b"] == 8
    with pytest.raises(ValueError, match="process_block"):
        part.save(str(tmp_path / "part"))
    with pytest.raises(ValueError, match="two partitioning owners"):
        ts.FleetSweep(params, plan, meta, seeds, horizon=HORIZON, global_b=8, mesh=make_fleet_mesh(device="cpu"),
                      device=CPU)
    with pytest.raises(ValueError, match="'batch' axis"):
        fleet_shard_put({}, Mesh(size=1, rank=0, device=CPU, transport="gloo"), 4)
    with pytest.raises(ValueError, match="contiguous"):
        ts.FleetSweep(params, plan, meta[1:] + meta[:1], seeds, horizon=HORIZON, device=CPU)
    # the surfaces' aot= (A15) is ported: the detection program runs through
    # the warm start with the answers it gives without it (against the JAX
    # package's with aot= on: the surface tests below)
    monkeypatch.setenv("RINGPOP_TPU_AOT_CACHE", str(tmp_path / "aot"))
    ticks, detected, info = ts.detect_surface(params, plan, seeds, VICTIMS, max_ticks=64, aot="tag", device=CPU)
    plain_ticks, plain_detected, plain_info = ts.detect_surface(params, plan, seeds, VICTIMS, max_ticks=64, device=CPU)
    assert np.array_equal(ticks, plain_ticks) and np.array_equal(detected, plain_detected) and plain_info == {}
    assert info["tag"].startswith("tag-mc1-f") and info["saved"] and info["error"] is None
    got = ts.refine_surface(params, victims=VICTIMS, losses=(0.0,), max_dose=4, max_ticks=64, aot="tag", device=CPU)
    plain = ts.refine_surface(params, victims=VICTIMS, losses=(0.0,), max_dose=4, max_ticks=64, device=CPU)
    assert {k: v for k, v in got.items() if k not in ("compiled_programs", "aot")} == \
        {k: v for k, v in plain.items() if k not in ("compiled_programs", "aot")}
    assert got["compiled_programs"] == 1 and plain["compiled_programs"] is None and plain["aot"] == {}


def test_fleet_sweep_hooks_see_every_block():
    class Obs:
        def __init__(self):
            self.calls = []

        def block_record(self, rec):
            self.calls.append(("record", rec["scenario_id"]))

        def progress(self, done, horizon, last_checkpoint_tick=None):
            self.calls.append(("progress", done, horizon, last_checkpoint_tick))

        def sync(self):
            self.calls.append(("sync",))

    obs, seen = Obs(), []
    plan, meta, seeds = fleet_grid(ts, device=CPU)
    sweep = ts.FleetSweep(tl.LifecycleParams(**FLEET), tc.slice_plan(plan, 0, 1), meta[:1], seeds[:1], horizon=8,
                          journal_every=4, obs=obs, on_block=lambda s: seen.append(s.ticks_done), device=CPU)
    sweep.run()
    assert seen == [4, 8]
    assert obs.calls == [("record", 0), ("progress", 4, 8, None), ("sync",),
                         ("record", 0), ("progress", 8, 8, None), ("sync",)]


# -- detection surfaces ----------------------------------------------------------------


SURF_KW = dict(victims=VICTIMS, losses=(0.0,), max_dose=12, churn_seed=777, max_ticks=256, check_every=1)


def test_detect_surface_matches_sequential_and_jax():
    """B = 3, the same width and plan structure as the cliff runners below,
    so the JAX side compiles one detection program for all of them."""
    kw = dict(victims=VICTIMS, doses=[0, 6, 12], churn_seed=777)
    jplan, jmeta = js.scenario_grid(N, **kw)
    tplan, tmeta = ts.scenario_grid(N, device=CPU, **kw)
    seeds = ts.grid_seeds(tmeta, 0)
    want_t, want_d, info = js.detect_surface(jl.LifecycleParams(**SURFACE), jplan, seeds, VICTIMS, max_ticks=256)
    got_t, got_d, got_info = ts.detect_surface(tl.LifecycleParams(**SURFACE), tplan, seeds, VICTIMS, max_ticks=256,
                                               device=CPU)
    assert want_d.all() and got_info == info == {}
    assert np.array_equal(got_t, want_t) and np.array_equal(got_d, want_d)
    seq_t, seq_d = ts.sequential_detect(tl.LifecycleParams(**SURFACE), tplan, seeds, VICTIMS, max_ticks=256,
                                        device=CPU)
    assert np.array_equal(seq_t, want_t) and np.array_equal(seq_d, want_d)


def test_refine_surface_matches_jax_live_output():
    want = js.refine_surface(jl.LifecycleParams(**SURFACE), coarse=3, **SURF_KW)
    got = ts.refine_surface(tl.LifecycleParams(**SURFACE), coarse=3, device=CPU, **SURF_KW)
    assert got == want
    assert want["dispatches"] > 2 and want["cliffs"][0.0]["cliff_at"] is not None
    assert got["compiled_programs"] is None and got["aot"] == {}


def test_surfaces_with_aot_match_jax_and_compile_once(tmp_path, monkeypatch):
    """The surfaces with ``aot=`` on in both packages: the same ticks and
    flags; every dispatch of the adaptive search's runner reuses its one
    keyed program (``tests/test_scenarios.py::test_refine_runner_compiles_once``),
    with the JAX package's record keys."""
    monkeypatch.setenv("RINGPOP_TPU_AOT_CACHE", str(tmp_path))
    kw = dict(victims=VICTIMS, doses=[0, 6, 12], churn_seed=777)
    jplan, jmeta = js.scenario_grid(N, **kw)
    tplan, _ = ts.scenario_grid(N, device=CPU, **kw)
    seeds = ts.grid_seeds(jmeta, 0)
    want_t, want_d, info = js.detect_surface(jl.LifecycleParams(**SURFACE), jplan, seeds, VICTIMS, max_ticks=256,
                                             aot="surf")
    got_t, got_d, got_info = ts.detect_surface(tl.LifecycleParams(**SURFACE), tplan, seeds, VICTIMS, max_ticks=256,
                                               aot="surf", device=CPU)
    assert np.array_equal(got_t, want_t) and np.array_equal(got_d, want_d) and want_d.all()
    assert set(got_info) == set(info) and got_info["tag"].rsplit("-f", 1)[0] == info["tag"].rsplit("-f", 1)[0]
    want = js.refine_surface(jl.LifecycleParams(**SURFACE), coarse=3, aot="refine", **SURF_KW)
    got = ts.refine_surface(tl.LifecycleParams(**SURFACE), coarse=3, aot="refine", device=CPU, **SURF_KW)
    assert {k: v for k, v in got.items() if k != "aot"} == {k: v for k, v in want.items() if k != "aot"}
    assert got["compiled_programs"] == want["compiled_programs"] == 1 and got["dispatches"] > 2
    assert set(got["aot"]) == set(want["aot"]) and got["aot"]["error"] is None


def test_dense_surface_matches_jax_live_output():
    want = js.dense_surface(jl.LifecycleParams(**SURFACE), width=3, **SURF_KW)
    got = ts.dense_surface(tl.LifecycleParams(**SURFACE), width=3, device=CPU, **SURF_KW)
    assert got == want
    assert len(want["curves"][0.0]) == 13 and want["all_detected"]
