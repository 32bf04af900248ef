"""The chaos plane: PyTorch port against the JAX package.

On the CPU, bit for bit: ``scenario_plan("smoke" | "churn" | "flap" |
"asym")`` and the builders under it, leg by leg; ``faults_at`` at every tick
of the horizon; ``constant_plan`` and ``validate_plan``'s refusals;
``stack_plans`` / ``index_plan`` / ``slice_plan`` / ``plan_axes`` /
``plan_batch_size`` (and the round trip of a stacked plan); ``up_at_host``,
``plan_events``, ``score_blocks`` and ``emit_score_stats``; the chaos-smoke
recipe (``scripts/chaos_smoke.py``: n = 256, k = 64, horizon 128, 16-tick
blocks, suspect_ticks 8) through both packages — the journal's blocks, the
verdict, the scored journal's round trip and the telemetry-on/off state
identity; an asym plan's directed-partition keys; and a plan carried
across from the JAX package (``plan_from_numpy``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.options import InMemoryStats as JStats
from ringpop_tpu.sim import chaos as jc
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import telemetry as jt
from ringpop_tpu_torch.options import InMemoryStats
from ringpop_tpu_torch.sim import chaos as tc
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim import telemetry as tt

CPU = torch.device("cpu")
SCENARIOS = ("smoke", "churn", "flap", "asym")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_same_plan(jplan, tplan):
    assert type(tplan).__name__ == "FaultPlan" and tplan._fields == jplan._fields
    for field, a, b in zip(jplan._fields, jplan, tplan):
        assert (a is None) == (b is None), field
        if a is None:
            continue
        a = np.asarray(a)
        b = tc._np(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (field, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), field


def assert_same_faults(jf, tf, where):
    for field in ("up", "group", "drop_rate", "drop_node", "reach", "tier_ids", "tier_drop", "suspect_ticks"):
        a, b = getattr(jf, field), getattr(tf, field)
        assert (a is None) == (b is None), (where, field)
        if a is not None:
            assert np.array_equal(np.asarray(a), tc._np(b)), (where, field)


@pytest.mark.parametrize("n", [64, 1000])
@pytest.mark.parametrize("name", SCENARIOS)
def test_scenario_plans_match_jax_leaf_by_leaf(name, n):
    jplan = jc.scenario_plan(name, n, seed=3, horizon=96)
    tplan = tc.scenario_plan(name, n, seed=3, horizon=96, device=CPU)
    assert_same_plan(jplan, tplan)
    assert tc.plan_events(tplan) == jc.plan_events(jplan)
    for tick in (0, 5, 40, 95):
        assert np.array_equal(tc.up_at_host(tplan, tick, n), jc.up_at_host(jplan, tick, n))


@pytest.mark.parametrize("name", SCENARIOS)
def test_faults_at_matches_jax_at_every_tick(name):
    n, horizon = 200, 128
    jplan = jc.scenario_plan(name, n, seed=1, horizon=horizon)
    tplan = tc.scenario_plan(name, n, seed=1, horizon=horizon, device=CPU)
    at = jax.jit(jc.faults_at)
    for tick in range(horizon + 2):
        # the engines evaluate at the state's tick, a 0-d int32 tensor
        t = torch.tensor(tick, dtype=torch.int32) if tick % 2 else tick
        assert_same_faults(at(jplan, jnp.int32(tick)), tplan.at_tick(t), tick)


def test_builders_match_jax_with_their_options():
    cases = [
        ("churn_plan", dict(n_churn=9, n_permanent=3, first=2, stagger=3, waves=3, down_ticks=10, seed=4)),
        ("churn_plan", {}),
        ("flap_plan", dict(n_flap=7, period=10, down=4, start=3, seed=2)),
        ("flap_plan", {}),
        ("asym_partition_plan", dict(minority=0.45, split_at=3, heal_at=50)),
    ]
    for fn, kw in cases:
        assert_same_plan(getattr(jc, fn)(300, **kw), getattr(tc, fn)(300, device=CPU, **kw))


def test_constant_plan_is_the_static_faults():
    up = np.ones(50, bool)
    up[[3, 9]] = False
    group = np.where(np.arange(50) < 20, 1, 0).astype(np.int32)
    tf = tc.DeltaFaults(up=torch.from_numpy(up), group=torch.from_numpy(group), drop_rate=0.1)
    plan = tc.constant_plan(tf)
    for tick in (0, 7, 1000):
        out = plan.at_tick(tick)
        assert out.up is tf.up and out.group is tf.group and out.drop_rate == tf.drop_rate
    # and the engines give the same state under the plan and under the faults
    params = tl.LifecycleParams(n=50, k=40, rng="counter", suspect_ticks=3)
    a = b = tl.init_state(params, seed=0, device=CPU)
    for _ in range(6):
        a, b = tl.step(params, a, tf), tl.step(params, b, plan)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", ["reach_float", "reach_ragged", "group_below", "group_oversized", "tier_half",
                                 "tier_levels", "tier_table", "tier_range", "suspect_zero", "flap_alone"])
def test_validate_plan_refuses_what_jax_refuses(bad):
    n = 8
    legs = {
        "reach_float": dict(reach=np.eye(2, dtype=np.float32)),
        "reach_ragged": dict(reach=np.ones((2, 3), bool)),
        "group_below": dict(group=np.full(n, -2, np.int32)),
        "group_oversized": dict(group=np.full(n, 2, np.int32), reach=np.eye(2, dtype=bool)),
        "tier_half": dict(tier_ids=np.zeros((3, n), np.int32)),
        "tier_levels": dict(tier_ids=np.zeros((2, n), np.int32), tier_drop=np.zeros(4, np.float32)),
        "tier_table": dict(tier_ids=np.zeros((3, n), np.int32), tier_drop=np.zeros(3, np.float32)),
        "tier_range": dict(tier_ids=np.zeros((3, n), np.int32), tier_drop=np.full(4, 1.5, np.float32)),
        "suspect_zero": dict(suspect_ticks=np.int32(0)),
        "flap_alone": dict(flap_period=np.full(n, 4, np.int32)),
    }[bad]
    with pytest.raises(ValueError) as jerr:
        jc.validate_plan(jc.FaultPlan(**{k: jnp.asarray(v) for k, v in legs.items()}))
    tplan = tc.FaultPlan(**{k: torch.from_numpy(np.asarray(v)) for k, v in legs.items()})
    with pytest.raises(ValueError) as terr:
        tc.validate_plan(tplan)
    assert str(terr.value).split(";")[0].split(" — ")[0] == str(jerr.value).split(";")[0].split(" — ")[0]


def test_merge_refuses_a_leg_set_twice():
    a = tc.churn_plan(20, device=CPU)
    with pytest.raises(ValueError, match="set by more than one plan"):
        tc._merge_plans(a, a)


def _members(n=120):
    jplans = [jc.scenario_plan(name, n, seed=i, horizon=64) for i, name in enumerate(SCENARIOS)]
    tplans = [tc.scenario_plan(name, n, seed=i, horizon=64, device=CPU) for i, name in enumerate(SCENARIOS)]
    jplans.append(jc.FaultPlan(suspect_ticks=jnp.int32(5), group=jnp.asarray(np.arange(n, dtype=np.int32) % 3)))
    tplans.append(tc.FaultPlan(suspect_ticks=torch.tensor(5, dtype=torch.int32),
                               group=torch.from_numpy(np.arange(n, dtype=np.int32) % 3)))
    return jplans, tplans


def test_stack_index_slice_match_jax_and_round_trip():
    jplans, tplans = _members()
    jstack, tstack = jc.stack_plans(jplans), tc.stack_plans(tplans)
    assert_same_plan(jstack, tstack)
    assert tc.plan_batch_size(tstack) == jc.plan_batch_size(jstack) == len(tplans)
    assert tc.plan_axes(tstack) == jc.plan_axes(jstack)
    assert tc.plan_axes(tplans[0]) is None and tc.plan_batch_size(tplans[0]) is None
    for b in range(len(tplans)):
        member = tc.index_plan(tstack, b)
        assert_same_plan(jc.index_plan(jstack, b), member)
        # a member's liveness and events are its solo plan's
        for tick in (0, 9, 33):
            assert np.array_equal(tc.up_at_host(member, tick, 120), tc.up_at_host(tplans[b], tick, 120))
            solo = tc.faults_at(tplans[b], tick)
            back = tc.faults_at(member, tick)
            assert torch.equal(back.up if back.up is not None else torch.ones(120, dtype=torch.bool),
                               solo.up if solo.up is not None else torch.ones(120, dtype=torch.bool))
        assert tc.plan_events(member) == jc.plan_events(jc.index_plan(jstack, b))
    sub = tc.slice_plan(tstack, 1, 4)
    assert_same_plan(jc.slice_plan(jstack, 1, 4), sub)
    assert tc.plan_batch_size(sub) == 3
    assert_same_plan(tc.index_plan(tstack, 2), tc.index_plan(sub, 1))
    with pytest.raises(ValueError, match="SOLO"):
        tc.stack_plans([tstack])
    with pytest.raises(ValueError, match="bad slice"):
        tc.slice_plan(tstack, 3, 1)


def test_plan_from_numpy_carries_a_jax_plan_across():
    jplan = jc.scenario_plan("asym", 500, seed=2, horizon=64)
    tplan = tc.plan_from_numpy(jax.tree_util.tree_map(np.asarray, jplan), device=CPU)
    assert_same_plan(jplan, tplan)
    legs = {f: tc._np(v) for f, v in zip(tplan._fields, tplan) if v is not None}
    assert_same_plan(jplan, tc.plan_from_numpy(legs, device=CPU))


def _run_smoke(sim_cls, plan, telemetry, **kw):
    n, k, seed, horizon, block = 256, 64, 0, 128, 16
    sim = sim_cls(n=n, k=k, seed=seed, suspect_ticks=8, rng="counter", telemetry=telemetry, **kw)
    for _ in range(horizon // block):
        sim.run(block, plan)
    return sim


def test_chaos_smoke_recipe_matches_jax(tmp_path):
    """``scripts/chaos_smoke.py``'s three certificates, through the port,
    each held to the JAX package's run of the same recipe."""
    n, horizon = 256, 128
    jplan = jc.scenario_plan("smoke", n, seed=0, horizon=horizon)
    tplan = tc.scenario_plan("smoke", n, seed=0, horizon=horizon, device=CPU)
    path = tmp_path / "chaos_smoke.jsonl"
    jsink = jt.TelemetrySink()
    jsim = _run_smoke(jl.LifecycleSim, jplan, jsink)
    with tt.TelemetryJournal(str(path)) as journal:
        journal.header("lifecycle", "chaos-smoke", {"n": n, "k": 64, "seed": 0})
        sink = tt.TelemetrySink(journal=journal)
        on = _run_smoke(tl.LifecycleSim, tplan, sink, device=CPU)
        score = tc.score_blocks(sink.records, tplan, n=n, scenario="chaos-smoke")
        journal.score(score)
    off = _run_smoke(tl.LifecycleSim, tplan, None, device=CPU)
    # 1: telemetry on/off identity under the time-varying plan
    for name, a, b in zip(tl.LifecycleState._fields, on.state, off.state):
        assert torch.equal(a, b), name
    assert int(tt.tree_digest(on.state)) == int(tt.tree_digest(off.state)) == int(jt.tree_digest(jsim.state))
    # 2: the journal and the verdict equal the JAX run's
    assert sink.records == jsink.records
    jscore = jc.score_blocks(jsink.records, jplan, n=n, scenario="chaos-smoke")
    assert score == jscore
    assert {"crash", "restart", "flap"} <= {e["kind"] for e in score["events"]}
    assert score["time_to_detect"] and score["suspects_declared"] > 0
    # 3: the scored journal round-trips
    records = tt.read_journal(str(path))
    blocks = [r for r in records if r["kind"] == "block"]
    scores = [r for r in records if r["kind"] == "score"]
    assert len(scores) == 1 and scores[0]["false_positive_suspects"] == score["false_positive_suspects"]
    assert sum(b["ticks"] for b in blocks) == horizon
    stats, jstats = InMemoryStats(), JStats()
    tc.emit_score_stats(stats, score)
    jc.emit_score_stats(jstats, jscore)
    assert stats.gauges == jstats.gauges and stats.gauges


def test_asym_plan_reports_the_directed_keys_of_jax():
    n, k, horizon = 400, 64, 96
    jplan = jc.scenario_plan("asym", n, seed=0, horizon=horizon)
    tplan = tc.scenario_plan("asym", n, seed=0, horizon=horizon, device=CPU)
    jsink, tsink = jt.TelemetrySink(), tt.TelemetrySink()
    kw = dict(n=n, k=k, seed=0, suspect_ticks=6, rng="counter")
    jsim = jl.LifecycleSim(telemetry=jsink, **kw)
    tsim = tl.LifecycleSim(telemetry=tsink, device=CPU, **kw)
    for _ in range(horizon // 16):
        jsim.run(16, jplan)
        tsim.run(16, tplan)
    assert tsink.records == jsink.records
    jscore, tscore = (c.score_blocks(s.records, p, n=n, scenario="asym") for c, s, p in
                      ((jc, jsink, jplan), (tc, tsink, tplan)))
    assert tscore == jscore
    assert tscore["refutations_unreachable_dir"] + tscore["refutations_reachable_dir"] == tscore["refutations"]
    assert tscore["refutations_unreachable_dir"] > 0
