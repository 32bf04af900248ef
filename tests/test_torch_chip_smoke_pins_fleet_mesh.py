"""The JAX pins of ``chip_smoke.py``'s phase 19 (the fleet's meshes, the
process-sliced sweep and its checkpoints), recomputed, and its recipes at
a small size.

``chip_smoke.py`` imports nothing of JAX, so what it holds the port to on
the card is constants.  Here the JAX package runs the same recipes on the
CPU, unsharded:

* 19a — simbench's fleet twin (``_fleet_sharded_twin``: 4096 x 64,
  ``suspect_ticks`` 10, counter, B = 6, 24 ticks with telemetry), then 16
  ticks of ``run_until_detected``: the 6 digests after the twin, the
  detection ticks and flags, and the digests after;
* 19b/c — simbench's ``fleet_scale`` sweep (4096 x 64, B = 64 with
  ``b_doses`` 16, horizon 32 in 16-tick blocks): every scenario's digest
  and the scores' hash (``chip_smoke.scores_sha256``).

The full-scale recomputations run the JAX package alone (some ten
seconds each on the CPU); each recipe also runs here at n 128 through both
packages, the port
through ``chip_smoke``'s own recipe functions on the CPU, unsharded (the
meshes are held to the unsharded fleet in tests/test_torch_fleet_mesh.py
and tests/test_torch_fleet_ckpt.py).
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import montecarlo as jm
from ringpop_tpu.sim import scenarios as js
from ringpop_tpu.sim import telemetry as jt

CPU = torch.device("cpu")
SMALL_N, SMALL_K = 128, 64
SMALL_SCALE = dict(n=SMALL_N, k=16, b_doses=2, losses=(0.0, 0.1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_twin(n, k):
    """``_fleet_sharded_twin``'s unsharded leg, then the detection leg."""
    params = jl.LifecycleParams(n=n, k=k, suspect_ticks=chip_smoke.FTWIN_SUSPECT_TICKS, rng="counter")
    victims = sorted(np.random.default_rng(chip_smoke.FTWIN_SEED).choice(n, size=4, replace=False).tolist())
    plan, meta = js.scenario_grid(n, victims=victims, doses=[0, n // 64, n // 32], losses=(0.0, 0.05),
                                  churn_seed=chip_smoke.FTWIN_SEED + 777)
    mc = jm.MonteCarlo(params, js.grid_seeds(meta, chip_smoke.FTWIN_SEED), telemetry=True)
    mc.run(chip_smoke.FTWIN_TICKS, plan)
    records = mc.fetch_telemetry(plan)
    ticks, det = mc.run_until_detected(victims, plan, max_ticks=chip_smoke.FTWIN_DETECT_TICKS,
                                       check_every=chip_smoke.FTWIN_CHECK_EVERY)
    return {"records": records, "digests": [r["state_digest"] for r in records],
            "detect": [[int(t) for t in ticks], [bool(d) for d in det]],
            "detect_digests": [int(d) for d in jax.jit(jax.vmap(jt.tree_digest))(mc.states)]}


def jax_scale(n=chip_smoke.FSCALE_N, k=chip_smoke.FSCALE_K, b_doses=chip_smoke.FSCALE_B_DOSES,
              losses=chip_smoke.FSCALE_LOSSES):
    """``fleet_bench``'s grid (``build_grid``) as one unbroken sweep."""
    params = jl.LifecycleParams(n=n, k=k, suspect_ticks=chip_smoke.FSCALE_SUSPECT_TICKS, rng="counter")
    victims = sorted(np.random.default_rng(chip_smoke.FSCALE_SEED).choice(n, size=4, replace=False).tolist())
    plan, meta = js.scenario_grid(n, victims=victims, doses=js.mc_churn_doses(b_doses, n // 32), losses=losses,
                                  churn_seed=chip_smoke.FSCALE_SEED + 777)
    sweep = js.FleetSweep(params, plan, meta, js.grid_seeds(meta, chip_smoke.FSCALE_SEED),
                          horizon=chip_smoke.FSCALE_HORIZON, journal_every=chip_smoke.FSCALE_BLOCK,
                          scenario="fleet_scale").run()
    return {"digests": sweep.digests(), "scores": sweep.scores()}


def pin_of(scale: dict) -> dict:
    return {"digests": {str(k): v for k, v in scale["digests"].items()},
            "scores_sha256": chip_smoke.scores_sha256(scale["scores"])}


# -- the recipes at a small size, both packages -------------------------------


def test_fleet_twin_recipe_small_matches_jax():
    want = jax_twin(SMALL_N, SMALL_K)
    got, _ = chip_smoke.fleet_twin_run(CPU, SMALL_N, SMALL_K)
    assert got == {key: want[key] for key in got}
    assert len(got["digests"]) == 6


def test_fleet_scale_recipe_small_matches_jax(tmp_path):
    want = jax_scale(**SMALL_SCALE)
    path = str(tmp_path / "ck")
    saved = chip_smoke.fleet_scale_sweep(CPU, path, save_at=chip_smoke.FSCALE_SAVE_AT, **SMALL_SCALE)
    restored = chip_smoke.fleet_scale_sweep(CPU, path, restore=True, **SMALL_SCALE)
    for got in (saved, restored):
        assert {"digests": got["digests"], "scores": got["scores"]} == want
        assert pin_of(got) == pin_of(want)
    assert restored["header"]["resumed"]["from_tick"] == chip_smoke.FSCALE_SAVE_AT
    assert len(want["digests"]) == 2 * len(SMALL_SCALE["losses"])


def test_scores_sha256_hashes_equal_records_alike():
    a = [{"x": 1, "y": [True, 2.5], "z": None}]
    assert chip_smoke.scores_sha256(a) == chip_smoke.scores_sha256([{"z": None, "y": [1, 2.5], "x": 1.0}])
    assert chip_smoke.scores_sha256(a) != chip_smoke.scores_sha256([{"x": 2, "y": [True, 2.5], "z": None}])


def test_pins_are_consistent():
    assert len(chip_smoke.PIN_FLEET_TWIN["digests"]) == len(chip_smoke.PIN_FLEET_TWIN["detect_digests"]) == 6
    assert len(chip_smoke.PIN_FLEET_SCALE["digests"]) == chip_smoke.FSCALE_B_DOSES * len(chip_smoke.FSCALE_LOSSES)
    assert sorted(int(k) for k in chip_smoke.PIN_FLEET_SCALE["digests"]) == list(range(64))


# -- the full-scale pins (JAX only) ------------------------------------------------


def test_phase19a_fleet_twin_pins_match_the_jax_package():
    got = jax_twin(chip_smoke.FTWIN_N, chip_smoke.FTWIN_K)
    assert {key: got[key] for key in chip_smoke.PIN_FLEET_TWIN} == chip_smoke.PIN_FLEET_TWIN


def test_phase19b_fleet_scale_pins_match_the_jax_package():
    assert pin_of(jax_scale()) == chip_smoke.PIN_FLEET_SCALE
