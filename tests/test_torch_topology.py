"""The topology plane: PyTorch port against the JAX package.

On the CPU, bit for bit: ``compile_topology`` and ``default_topology``
(tier ids, the per-tier loss table, the index helpers), ``late_ack_prob``
and the spec refusals; every ``topo_scenario_plan`` and the
``topo_scenario_specs`` family, leg by leg, and their stack; a
``telemetry_tiers=True`` lifecycle run under a topology plan, whose eight
per-tier block keys, verdict and state equal the JAX package's; and
``emit_topo_stats``.
"""

import numpy as np
import pytest
import torch

from ringpop_tpu.options import InMemoryStats as JStats
from ringpop_tpu.sim import chaos as jc
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import telemetry as jt
from ringpop_tpu.sim import topology as jtop
from ringpop_tpu_torch.options import InMemoryStats
from ringpop_tpu_torch.sim import chaos as tc
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim import telemetry as tt
from ringpop_tpu_torch.sim import topology as ttop
from tests.test_torch_chaos import assert_same_plan

CPU = torch.device("cpu")
NAMES = ("zone_loss", "switch_flap", "wan", "independent", "flat", "smoke")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPECS = [
    {},
    dict(regions=3, zones_per_region=2, racks_per_zone=4, probe_timeout_ms=250.0),
    dict(rack_link=dict(rtt_ms=1.0, loss=0.01), zone_link=dict(rtt_ms=0.0, loss=0.0),
         region_link=dict(rtt_ms=300.0, loss=0.1)),
]


def _spec_kw(mod, kw):
    return {k: (mod.TierLink(**v) if isinstance(v, dict) else v) for k, v in kw.items()}


@pytest.mark.parametrize("n", [24, 100, 4096])
@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_compiled_tables_match_jax(spec, n):
    jt_ = jtop.default_topology(n, **_spec_kw(jtop, SPECS[spec]))
    tt_ = ttop.default_topology(n, **_spec_kw(ttop, SPECS[spec]))
    assert tt_.n == jt_.n and tt_.tier_ids.dtype == jt_.tier_ids.dtype == np.int32
    assert np.array_equal(tt_.tier_ids, jt_.tier_ids)
    assert tt_.tier_drop.dtype == np.float32 and np.array_equal(tt_.tier_drop, jt_.tier_drop)
    assert tt_.has_penalties() == jt_.has_penalties()
    for z in range(tt_.spec.total_zones):
        assert np.array_equal(tt_.nodes_in_zone(z), jt_.nodes_in_zone(z))
    rng = np.random.default_rng(n)
    a, b = rng.integers(0, n, 50), rng.integers(0, n, 50)
    assert np.array_equal(tt_.tier_of_pair(a, b), jt_.tier_of_pair(a, b))
    flat = ttop.compile_topology(ttop.TopologySpec(regions=2, zones_per_region=2), max(n, 4))
    assert flat.plan_legs(device=CPU) == tc.FaultPlan() and not flat.has_penalties()
    assert_same_plan(jtop.compile_topology(jtop.TopologySpec(regions=2, zones_per_region=2), max(n, 4))
                     .plan_legs(force=True), flat.plan_legs(force=True, device=CPU))


def test_late_ack_prob_and_spec_refusals_match_jax():
    for rtt, timeout in ((0.0, 400.0), (120.0, 400.0), (5.0, 1.0), (1e6, 400.0)):
        assert ttop.late_ack_prob(rtt, timeout) == jtop.late_ack_prob(rtt, timeout)
    for bad in (dict(regions=0), dict(regions=8, zones_per_region=2), dict(rack_link=dict(loss=1.0)),
                dict(zone_link=dict(rtt_ms=-1.0))):
        with pytest.raises(ValueError) as jerr:
            jtop.compile_topology(jtop.TopologySpec(**_spec_kw(jtop, bad)), 10)
        with pytest.raises(ValueError) as terr:
            ttop.compile_topology(ttop.TopologySpec(**_spec_kw(ttop, bad)), 10)
        assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("name", NAMES)
def test_topo_scenario_plans_match_jax_leaf_by_leaf(name):
    for n, horizon in ((64, 64), (4096, 256)):
        jplan = jtop.topo_scenario_plan(name, n, seed=2, horizon=horizon)
        tplan = ttop.topo_scenario_plan(name, n, seed=2, horizon=horizon, device=CPU)
        assert_same_plan(jplan, tplan)
        assert tc.plan_events(tplan) == jc.plan_events(jplan)


def test_partition_plan_options_and_refusals_match_jax():
    jtopo, ttopo = jtop.default_topology(256), ttop.default_topology(256)
    for kw in (dict(level="zone", cut=(1, 2)), dict(level="rack", cut=(0,), heal_at=30, one_way=True)):
        assert_same_plan(jtop.partition_plan(jtopo, **kw), ttop.partition_plan(ttopo, device=CPU, **kw))
    for kw in (dict(level="row"), dict(cut=()), dict(cut=(9,)), dict(level="region", cut=(0, 1))):
        with pytest.raises(ValueError) as jerr:
            jtop.partition_plan(jtopo, **kw)
        with pytest.raises(ValueError) as terr:
            ttop.partition_plan(ttopo, device=CPU, **kw)
        assert str(terr.value) == str(jerr.value)


def test_topo_scenario_specs_match_jax_and_stack():
    jtopo, ttopo = jtop.default_topology(512), ttop.default_topology(512)
    jplans, jmeta = jtop.topo_scenario_specs(jtopo, seed=1, horizon=128, reps=2)
    tplans, tmeta = ttop.topo_scenario_specs(ttopo, seed=1, horizon=128, reps=2, device=CPU)
    assert tmeta == jmeta and len(tplans) == len(jplans)
    for a, b in zip(jplans, tplans):
        assert_same_plan(a, b)
    assert_same_plan(jc.stack_plans(jplans), tc.stack_plans(tplans))


def test_tier_armed_run_matches_jax():
    """``telemetry_tiers=True`` under the topology ``smoke`` plan: the
    eight per-tier keys of every block, the verdict's per-tier breakdowns
    and the final state equal the JAX package's, and the tier-armed run
    leaves the state as the unarmed one does."""
    n, k, horizon = 256, 32, 96
    jplan = jtop.topo_scenario_plan("smoke", n, seed=0, horizon=horizon)
    tplan = ttop.topo_scenario_plan("smoke", n, seed=0, horizon=horizon, device=CPU)
    kw = dict(n=n, k=k, seed=0, suspect_ticks=6, rng="counter")
    jsink, tsink = jt.TelemetrySink(), tt.TelemetrySink()
    jsim = jl.LifecycleSim(telemetry=jsink, telemetry_tiers=True, **kw)
    tsim = tl.LifecycleSim(telemetry=tsink, telemetry_tiers=True, device=CPU, **kw)
    plain = tl.LifecycleSim(device=CPU, **kw)
    for _ in range(horizon // 16):
        jsim.run(16, jplan)
        tsim.run(16, tplan)
        plain.run(16, tplan)
    tier_keys = {f"{pre}_{key}" for pre in ("suspects", "false_suspects") for key in tt.TIER_KEYS}
    assert len(tier_keys) == 8 and all(tier_keys <= set(r) for r in tsink.records)
    assert tsink.records == jsink.records
    assert sum(r[key] for r in tsink.records for key in tier_keys if key.startswith("suspects")) > 0
    for a, b in zip(tsim.state, plain.state):
        assert torch.equal(a, b)
    jscore = jc.score_blocks(jsink.records, jplan, n=n, scenario="topo")
    tscore = tc.score_blocks(tsink.records, tplan, n=n, scenario="topo")
    assert tscore == jscore and "time_to_detect_by_tier" in tscore
    stats, jstats = InMemoryStats(), JStats()
    ttop.emit_topo_stats(stats, {**tscore, "refutations_unreachable_dir": 3, "refutations_reachable_dir": 1})
    jtop.emit_topo_stats(jstats, {**jscore, "refutations_unreachable_dir": 3, "refutations_reachable_dir": 1})
    assert stats.gauges == jstats.gauges and len(stats.gauges) >= 8
