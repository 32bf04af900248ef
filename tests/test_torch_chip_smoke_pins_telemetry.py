"""The JAX pins of ``chip_smoke.py``'s phase 14 (the telemetry plane and the
chaos and topology plans), recomputed, and its recipes at a small size.

``chip_smoke.py`` imports nothing of JAX, so the block records, verdicts
and tick counts it holds the port to are constants.  Here the JAX package
runs the same recipes on the CPU:

* 14b — phase 9's headline (1,000,000 x 256, 1000 victims, counter) with a
  ``TelemetrySink`` and ``journal_views=True``;
* 14c — simbench's ``churn100k`` (100,000 x 256, the churn plan, horizon
  256 in 16-tick blocks, suspect_ticks 10);
* 14d — ``topo_scenario_plan("zone_loss")`` at ``bench_topo_chaos``'s
  width (4096 x 32) with the per-tier counters;
* 14e — BASELINE config 4, ``partition1m`` (1,000,000 x 128 on the delta
  engine).

The full-scale recomputations are marked ``slow`` (about 85, 25, 5 and 30
s of JAX on the CPU, over the tier-1 budget); each recipe also runs here at
a small size through both packages, the port through ``chip_smoke``'s own
recipe functions on the CPU, with records, verdicts and ticks equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.sim import chaos as jc
from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import telemetry as jt
from ringpop_tpu.sim import topology as jtop
from ringpop_tpu_torch.sim import chaos as tc
from ringpop_tpu_torch.sim import telemetry as tt
from ringpop_tpu_torch.sim import topology as ttop

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_headline(n, k):
    victims = chip_smoke.headline_victims(n)
    up = np.ones(n, bool)
    up[victims] = False
    sink = jt.TelemetrySink()
    sim = jl.LifecycleSim(n=n, k=k, seed=chip_smoke.LIFE_SEED, rng="counter", telemetry=sink, journal_views=True)
    kw = dict(max_ticks=chip_smoke.LIFE_MAX_TICKS, check_every=chip_smoke.LIFE_CHECK_EVERY, blocks_per_dispatch=8)
    faults = jd.DeltaFaults(up=jnp.asarray(up))
    detect = sim.run_until_detected(victims, faults, **kw)
    converge = sim.run_until_converged(faults, **kw)
    return {"detect": list(detect), "converge": list(converge), "records": sink.records}, sim


def jax_chaos(plan, n, k, scenario, tiers=False):
    sink = jt.TelemetrySink()
    sim = jl.LifecycleSim(n=n, k=k, seed=chip_smoke.TEL_SEED, suspect_ticks=chip_smoke.TEL_SUSPECT_TICKS,
                          rng="counter", telemetry=sink, telemetry_tiers=tiers)
    for _ in range(chip_smoke.TEL_HORIZON // chip_smoke.TEL_BLOCK):
        sim.run(chip_smoke.TEL_BLOCK, plan)
    return {"records": sink.records, "score": jc.score_blocks(sink.records, plan, n=n, scenario=scenario)}


def jax_partition(n, k):
    group = np.zeros(n, np.int32)
    group[: int(chip_smoke.TEL_PART_MINORITY * n)] = 1
    part = jd.DeltaFaults(up=jnp.ones(n, bool), group=jnp.asarray(group))
    heal = jd.DeltaFaults(up=jnp.ones(n, bool))
    records = []
    sim = jd.DeltaSim(n=n, k=k, seed=chip_smoke.TEL_SEED, rng="counter",
                      telemetry_sink=lambda r: records.append(jt._to_host(r)))
    t_part, _ = sim.run_until_converged(part, max_ticks=chip_smoke.TEL_PART_TICKS)
    t_heal, ok = sim.run_until_converged(heal, max_ticks=chip_smoke.TEL_HEAL_TICKS)
    return {"partition_ticks": t_part, "heal_ticks": t_heal, "converged": ok, "records": records}


def _port_partition(n, k):
    res = chip_smoke.tel_partition_run(CPU, n, k)
    res["records"] = [tt._to_host(r) for r in res["records"]]
    return res


# -- the recipes at a small size, both packages -------------------------------


def test_headline_recipe_small_matches_jax():
    n, k = 3000, 64
    want, jsim = jax_headline(n, k)
    got, tsim = chip_smoke.tel_headline_run(CPU, n, k)
    assert got == want
    assert want["detect"][1] and len(want["records"]) >= 2
    assert got["records"][-1]["state_digest"] == int(jt.tree_digest(jsim.state)) == int(tt.tree_digest(tsim.state))


def test_churn_recipe_small_matches_jax():
    n, k = 1000, 64
    jplan = jc.scenario_plan("churn", n, seed=chip_smoke.TEL_SEED, horizon=chip_smoke.TEL_HORIZON)
    tplan = tc.scenario_plan("churn", n, seed=chip_smoke.TEL_SEED, horizon=chip_smoke.TEL_HORIZON, device=CPU)
    want = jax_chaos(jplan, n, k, "churn-small")
    got, _ = chip_smoke.tel_chaos_run(CPU, tplan, n, k, "churn-small")
    assert got == want
    assert want["score"]["time_to_detect"] and want["score"]["suspects_declared"] > 0


def test_topology_recipe_small_matches_jax():
    n, k = 512, 32
    jplan = jtop.topo_scenario_plan("zone_loss", n, seed=chip_smoke.TEL_SEED, horizon=chip_smoke.TEL_HORIZON)
    tplan = ttop.topo_scenario_plan("zone_loss", n, seed=chip_smoke.TEL_SEED, horizon=chip_smoke.TEL_HORIZON,
                                    device=CPU)
    want = jax_chaos(jplan, n, k, "zone-small", tiers=True)
    got, _ = chip_smoke.tel_chaos_run(CPU, tplan, n, k, "zone-small", tiers=True)
    assert got == want
    assert sum(want["score"]["suspects_by_tier"].values()) > 0


def test_partition_recipe_small_matches_jax():
    want = jax_partition(5000, 64)
    got = _port_partition(5000, 64)
    assert got == want
    assert want["converged"] and want["partition_ticks"] == chip_smoke.TEL_PART_TICKS


def test_pins_are_consistent_with_phase_9():
    assert chip_smoke.PIN_TEL_HEADLINE["detect"] == [chip_smoke.PIN_LIFE_DETECT_TICKS, True]
    assert chip_smoke.PIN_TEL_HEADLINE["converge"] == [chip_smoke.PIN_LIFE_CONVERGE_TICKS, True]
    last = chip_smoke.PIN_TEL_HEADLINE["records"][-1]
    assert last["views_sum"] == chip_smoke.PIN_LIFE_VIEWS_SUM and last["views_agree"] is True
    for pin in (chip_smoke.PIN_TEL_CHURN, chip_smoke.PIN_TEL_TOPO):
        assert len(pin["records"]) == chip_smoke.TEL_HORIZON // chip_smoke.TEL_BLOCK == pin["score"]["blocks"]


# -- the full-scale pins (JAX only) ------------------------------------------------


@pytest.mark.slow
def test_phase14b_headline_pins_match_the_jax_package():
    got, sim = jax_headline(chip_smoke.LIFE_N, chip_smoke.LIFE_K)
    assert got == chip_smoke.PIN_TEL_HEADLINE
    digests = chip_smoke.leaf_digests(jl.LifecycleState(*(np.asarray(x) for x in sim.state)),
                                      jl.LifecycleState._fields)
    assert digests == chip_smoke.PIN_LIFE


@pytest.mark.slow
def test_phase14c_churn100k_pins_match_the_jax_package():
    n = chip_smoke.TEL_CHURN_N
    plan = jc.scenario_plan("churn", n, seed=chip_smoke.TEL_SEED, horizon=chip_smoke.TEL_HORIZON)
    got = jax_chaos(plan, n, chip_smoke.TEL_CHURN_K, "churn100k")
    assert got == chip_smoke.PIN_TEL_CHURN


@pytest.mark.slow
def test_phase14d_topology_pins_match_the_jax_package():
    n = chip_smoke.TEL_TOPO_N
    plan = jtop.topo_scenario_plan("zone_loss", n, seed=chip_smoke.TEL_SEED, horizon=chip_smoke.TEL_HORIZON)
    got = jax_chaos(plan, n, chip_smoke.TEL_TOPO_K, "topo_zone_loss", tiers=True)
    assert got == chip_smoke.PIN_TEL_TOPO


@pytest.mark.slow
def test_phase14e_partition1m_pins_match_the_jax_package():
    got = jax_partition(chip_smoke.TEL_PART_N, chip_smoke.TEL_PART_K)
    assert got == chip_smoke.PIN_TEL_PARTITION
