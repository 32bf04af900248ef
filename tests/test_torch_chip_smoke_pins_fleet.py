"""The JAX pins of ``chip_smoke.py``'s phase 15 (the scenario fleet),
recomputed, and its recipes at a small size.

``chip_smoke.py`` imports nothing of JAX, so the distributions, curves,
verdicts and digests it holds the port to are constants.  Here the JAX
package runs the same recipes on the CPU:

* 15a — simbench's ``montecarlo`` (4096 x 32, 32 replicas, threefry, 4
  victims, detection checked every tick): the distribution and every
  replica's final digest;
* 15b — simbench's ``mc_churn``: the dose-response curve, its cliff and
  the three 2-replica contrasts;
* 15c — mc_chaos's scored journal on the grid's corner (4 scenarios x 256
  ticks in 16-tick blocks): the verdicts and digests (the port's run saved
  at tick 128 and its restored twin must both reach them).

The full-scale recomputations are marked ``slow`` (tens of seconds of JAX
on the CPU each, over the tier-1 budget); each recipe also runs here at a
small size (n 128, 2-4 replicas, a 32-tick horizon) through both packages, the port
through ``chip_smoke``'s own recipe functions on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import montecarlo as jm
from ringpop_tpu.sim import scenarios as js
from ringpop_tpu.sim import telemetry as jt

CPU = torch.device("cpu")
# the small size: n 128, 4 replicas (2 in the churn study, whose main run then
# shares its JAX program with the first contrast), a 32-tick horizon
SMALL_N, SMALL_B, SMALL_CHURN_B, SMALL_HORIZON = 128, 4, 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_mc(n, b, k=chip_smoke.FLEET_K, max_ticks=chip_smoke.FLEET_MC_MAX_TICKS):
    victims = chip_smoke.fleet_victims(n)
    params = jl.LifecycleParams(n=n, k=k)
    up = np.ones(n, bool)
    up[victims] = False
    mc = jm.MonteCarlo(params, range(chip_smoke.FLEET_SEED, chip_smoke.FLEET_SEED + b))
    ticks, det = mc.run_until_detected(victims, jd.DeltaFaults(up=jnp.asarray(up)), max_ticks=max_ticks,
                                       check_every=1)
    dist = jm._distribution(ticks, det, b, params.tick_ms / 1000.0)
    digests = [int(d) for d in jax.jit(jax.vmap(jt.tree_digest))(mc.states)]
    return {"distribution": dist, "digests": digests}


def jax_churn(n, b, k=chip_smoke.FLEET_K, max_ticks=chip_smoke.FLEET_CHURN_MAX_TICKS):
    """bench_mc_churn's recipe (cli/simbench.py:1064-1143) at any n."""
    victims = chip_smoke.fleet_victims(n)
    churn_max = n // 32
    out = jm.detection_latency_under_churn(
        n=n, seeds=range(chip_smoke.FLEET_SEED, chip_smoke.FLEET_SEED + b), victims=victims, churn_max=churn_max,
        k=k, max_ticks=max_ticks, churn_seed=chip_smoke.FLEET_CHURN_SEED)
    cliff_at, jump = js.locate_cliff(out["churn_ticks"])
    base = jl.LifecycleParams(n=n, k=k)
    contrast = {"maxp_default": base.resolved_max_p()}
    for label, kw in ((f"k{k}_maxp_default", dict(k=k)), (f"k{k}_maxp_x3", dict(k=k, max_p=3 * base.resolved_max_p())),
                      (f"k{2 * k}_maxp_default", dict(k=2 * k))):
        o = jm.detection_latency_under_churn(
            n=n, seeds=[chip_smoke.FLEET_SEED, chip_smoke.FLEET_SEED + 1], victims=victims, churn_max=churn_max,
            max_ticks=max_ticks, churn_seed=chip_smoke.FLEET_CONTRAST_SEED, **kw)
        contrast[label] = o["churn_ticks"]
    return {"churn_ticks": out["churn_ticks"], "churn_cliff_at": cliff_at, "cliff_jump_ticks": jump,
            "detected": out["detected"], "cliff_contrast": contrast}


def jax_scored(n, k=chip_smoke.FLEET_K, horizon=chip_smoke.FLEET_HORIZON):
    plan, meta = js.scenario_grid(n, victims=chip_smoke.fleet_victims(n), doses=[0, n // 32],
                                  losses=chip_smoke.FLEET_LOSSES, churn_seed=chip_smoke.FLEET_CHURN_SEED)
    sink = jt.TelemetrySink()
    sweep = js.FleetSweep(jl.LifecycleParams(n=n, k=k), plan, meta, js.grid_seeds(meta, chip_smoke.FLEET_SEED),
                          horizon=horizon, journal_every=chip_smoke.FLEET_BLOCK, sink=sink, scenario="mc_chaos")
    sweep.run()
    # the digests at the horizon, as the last block's records carry them
    digests = {rec["scenario_id"]: rec["state_digest"] for rec in sink.records[-len(meta):]}
    return {"scores": sweep.scores(), "digests": digests}


# -- the recipes at a small size, both packages -------------------------------


def test_montecarlo_recipe_small_matches_jax():
    want = jax_mc(SMALL_N, SMALL_B)
    got, _ = chip_smoke.fleet_mc_run(CPU, SMALL_N, SMALL_B)
    assert got == want
    # the recipe is detection_latency_distribution's
    assert want["distribution"] == jm.detection_latency_distribution(
        n=SMALL_N, seeds=range(SMALL_B), victims=chip_smoke.fleet_victims(SMALL_N), k=chip_smoke.FLEET_K,
        max_ticks=chip_smoke.FLEET_MC_MAX_TICKS)
    assert want["distribution"]["detected"] == SMALL_B


def test_churn_recipe_small_matches_jax():
    want = jax_churn(SMALL_N, SMALL_CHURN_B)
    got = chip_smoke.fleet_churn_run(CPU, SMALL_N, SMALL_CHURN_B)
    assert got == want
    assert want["detected"] == SMALL_CHURN_B and len(want["cliff_contrast"]) == 4


def test_scored_recipe_small_matches_jax(tmp_path):
    want = jax_scored(SMALL_N, horizon=SMALL_HORIZON)
    got = chip_smoke.fleet_scored_run(CPU, str(tmp_path / "ck"), SMALL_N, horizon=SMALL_HORIZON,
                                      save_at=SMALL_HORIZON // 2)
    assert got["scores"] == want["scores"] == got["resumed_scores"]
    assert got["digests"] == want["digests"] == got["resumed_digests"]
    assert got["resumed_from"] == SMALL_HORIZON // 2


def test_pins_are_consistent():
    dist = chip_smoke.PIN_FLEET_MC["distribution"]
    assert dist["n_replicas"] == dist["detected"] == chip_smoke.FLEET_B == len(chip_smoke.PIN_FLEET_MC["digests"])
    churn = chip_smoke.PIN_FLEET_CHURN
    assert [c for c, _ in churn["churn_ticks"]] == js.mc_churn_doses(chip_smoke.FLEET_B, chip_smoke.FLEET_N // 32)
    assert (churn["churn_cliff_at"], churn["cliff_jump_ticks"]) == js.locate_cliff(churn["churn_ticks"])
    scored = chip_smoke.PIN_FLEET_SCORED
    assert sorted(scored["digests"]) == [s["scenario_id"] for s in scored["scores"]] == [0, 1, 2, 3]
    assert all(s["blocks"] == chip_smoke.FLEET_HORIZON // chip_smoke.FLEET_BLOCK for s in scored["scores"])


# -- the full-scale pins (JAX only) ------------------------------------------------


@pytest.mark.slow
def test_phase15a_montecarlo_pins_match_the_jax_package():
    assert jax_mc(chip_smoke.FLEET_N, chip_smoke.FLEET_B) == chip_smoke.PIN_FLEET_MC


@pytest.mark.slow
def test_phase15b_churn_pins_match_the_jax_package():
    got = jax_churn(chip_smoke.FLEET_N, chip_smoke.FLEET_B)
    assert {k: got[k] for k in chip_smoke.PIN_FLEET_CHURN} == chip_smoke.PIN_FLEET_CHURN


@pytest.mark.slow
def test_phase15c_scored_pins_match_the_jax_package():
    assert jax_scored(chip_smoke.FLEET_N) == chip_smoke.PIN_FLEET_SCORED
