"""The port's Monte-Carlo fleet (``ringpop_tpu_torch/sim/montecarlo.py``)
against the JAX package's, bit for bit, on the CPU.

Every recipe runs once in each package (module-scoped fixtures; a JAX
fleet program compiles once a recipe): the replicas' initial leaves
(seeds past 2**32 and negative ones included), a few ``run`` ticks at both
streams, ``run_until_detected`` at ``check_every`` 1 (through
``detection_latency_distribution``'s own program) and 4 (batched ``up`` and
``drop_rate`` legs beside a shared ``group``), the churn study, a stacked
chaos plan with telemetry (every ``fetch_telemetry`` record, state digest
included), the B = 1 fleet against the solo ``LifecycleSim``, the fleet
through the warm start and the refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import chaos as jc
from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import montecarlo as jm
from ringpop_tpu_torch.sim import chaos as tc
from ringpop_tpu_torch.sim import delta as td
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim import montecarlo as tm
from ringpop_tpu_torch.sim import telemetry as tt

CPU = torch.device("cpu")
N, K = 64, 16
SEEDS = [3, 7, 11, 19]
VICTIMS = [5, 42]
SUSPECT = 6  # a short suspicion timeout: detection in a dozen ticks


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def assert_states_equal(jax_states, port_states, what=""):
    want = jl.LifecycleState(*(np.asarray(x) for x in jax_states))
    got = tl.state_to_numpy(port_states)
    for field in jl.LifecycleState._fields:
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype and np.array_equal(g, w), f"{what} {field}"


def assert_records_equal(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, wv in w.items():
            assert type(g[key]) is type(wv) and g[key] == wv, (key, g[key], wv)


def up_mask(batch=None):
    up = np.ones(N if batch is None else (batch, N), bool)
    up[..., VICTIMS] = False
    if batch is not None:
        for b in range(batch):  # replica b crashes b extra nodes
            up[b, 20:20 + b] = False
    return up


# -- init and run --------------------------------------------------------------


def test_init_replicas_every_leaf_and_huge_seeds():
    seeds = [0, 2**32, 2**32 + 5, 2**40 + 7, -3]
    want = jm.init_replicas(jl.LifecycleParams(n=N, k=K), seeds)
    got = tm.init_replicas(tl.LifecycleParams(n=N, k=K), seeds, device=CPU)
    assert got.learned.shape == (len(seeds), N, 1) and got.key.shape == (len(seeds), 2)
    assert_states_equal(want, got)
    # the key-taking init is the solo init's
    for b, s in enumerate(seeds):
        solo = tl.init_state_from_key(tl.LifecycleParams(n=N, k=K), np.asarray(want.key[b]), device=CPU)
        assert torch.equal(solo.key, tl.init_state(tl.LifecycleParams(n=N, k=K), seed=s, device=CPU).key)


def test_run_every_leaf_threefry():
    """``run`` at the threefry stream (the counter stream's ``run`` is held
    by the stacked-plan test below)."""
    jmc = jm.MonteCarlo(jl.LifecycleParams(n=N, k=K), SEEDS)
    jmc.run(4, jd.DeltaFaults(up=jnp.asarray(up_mask())))
    tmc = tm.MonteCarlo(tl.LifecycleParams(n=N, k=K), SEEDS, device=CPU)
    tmc.run(4, td.DeltaFaults(up=torch.as_tensor(up_mask())))
    assert_states_equal(jmc.states, tmc.states)
    # each replica is the solo engine's run
    sim = tl.LifecycleSim(n=N, k=K, seed=SEEDS[2], device=CPU)
    sim.run(4, td.DeltaFaults(up=torch.as_tensor(up_mask())))
    assert tt.tree_digest(sim.state) == tt.tree_digest(tl.LifecycleState(*(x[2] for x in tmc.states)))


# -- detection -------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_every_tick():
    """``check_every`` 1 on a shared ``up``: the distribution helper and a
    fleet of the same program (one compile)."""
    dist = jm.detection_latency_distribution(n=N, seeds=SEEDS, victims=VICTIMS, k=K, suspect_ticks=SUSPECT,
                                             max_ticks=256)
    mc = jm.MonteCarlo(jl.LifecycleParams(n=N, k=K, suspect_ticks=SUSPECT), SEEDS)
    ticks, det = mc.run_until_detected(VICTIMS, jd.DeltaFaults(up=jnp.asarray(up_mask())), max_ticks=256,
                                       check_every=1)
    return dist, ticks, det, mc.states


def test_detection_every_tick_ticks_leaves_and_distribution(jax_every_tick):
    dist, ticks, det, states = jax_every_tick
    tmc = tm.MonteCarlo(tl.LifecycleParams(n=N, k=K, suspect_ticks=SUSPECT), SEEDS, device=CPU)
    got_ticks, got_det = tmc.run_until_detected(VICTIMS, td.DeltaFaults(up=torch.as_tensor(up_mask())),
                                                max_ticks=256, check_every=1)
    assert det.all() and np.array_equal(got_ticks, ticks) and np.array_equal(got_det, det)
    assert_states_equal(states, tmc.states, "check_every=1")
    got = tm.detection_latency_distribution(n=N, seeds=SEEDS, victims=VICTIMS, k=K, suspect_ticks=SUSPECT,
                                            max_ticks=256, device=CPU)
    assert got == dist and got["ticks_all"] == sorted(int(t) for t in ticks)


def test_detection_mixed_batched_and_shared_legs_every_four_ticks():
    """Batched ``up`` [B, N] and ``drop_rate`` [B] beside a shared
    ``group`` [N], counter stream, ``check_every`` 4: the first-detection
    ticks, every final leaf and the per-replica detection fractions."""
    group = np.zeros(N, np.int32)
    group[N // 2:] = -1
    rates = np.asarray([0.0, 0.05, 0.1, 0.2], np.float32)
    jf = jd.DeltaFaults(up=jnp.asarray(up_mask(len(SEEDS))), drop_rate=jnp.asarray(rates),
                        group=jnp.asarray(group))
    tf = td.DeltaFaults(up=torch.as_tensor(up_mask(len(SEEDS))), drop_rate=torch.as_tensor(rates),
                        group=torch.as_tensor(group))
    assert jm._faults_axes(jf) == jd.DeltaFaults(up=0, drop_rate=0)
    assert tm._faults_axes(tf) == td.DeltaFaults(up=0, drop_rate=0)
    jmc = jm.MonteCarlo(jl.LifecycleParams(n=N, k=K, suspect_ticks=SUSPECT, rng="counter"), SEEDS)
    ticks, det = jmc.run_until_detected(VICTIMS, jf, max_ticks=512, check_every=4)
    tmc = tm.MonteCarlo(tl.LifecycleParams(n=N, k=K, suspect_ticks=SUSPECT, rng="counter"), SEEDS, device=CPU)
    got_ticks, got_det = tmc.run_until_detected(VICTIMS, tf, max_ticks=512, check_every=4)
    assert det.all() and len(set(ticks.tolist())) > 1
    assert np.array_equal(got_ticks, ticks) and np.array_equal(got_det, det)
    assert_states_equal(jmc.states, tmc.states, "check_every=4")
    assert np.array_equal(tmc.detection_fractions(VICTIMS, tf), jmc.detection_fractions(VICTIMS, jf))
    # the entry check: an already-detected fleet reports tick 0 without stepping
    tick = tmc.states.tick.clone()
    again, ok = tmc.run_until_detected(VICTIMS, tf, max_ticks=512, check_every=4)
    assert ok.all() and not again.any() and torch.equal(tmc.states.tick, tick)
    # an exhausted budget reports -1
    cold = tm.MonteCarlo(tl.LifecycleParams(n=N, k=K, suspect_ticks=SUSPECT, rng="counter"), SEEDS[:1], device=CPU)
    assert cold.run_until_detected(VICTIMS, tm._index_faults(tf, 0), max_ticks=3, check_every=2)[0].tolist() == [-1]
    assert cold.states.tick.tolist() == [4]  # ceil(3 / 2) blocks


def test_churn_study_matches_jax():
    kw = dict(n=N, seeds=range(4), victims=VICTIMS, churn_max=12, k=K, suspect_ticks=SUSPECT, max_ticks=512,
              churn_seed=777)
    want = jm.detection_latency_under_churn(**kw)
    got = tm.detection_latency_under_churn(**kw, device=CPU)
    assert got == want
    assert want["churn_counts"] == [0, 4, 8, 12] and want["detected"] == 4


# -- a stacked chaos plan with telemetry ------------------------------------------------


def test_stacked_plan_telemetry_records_match_jax():
    """Three scenarios of the chaos plane stacked into one plan, telemetry
    on: every block record of ``fetch_telemetry`` (state digest included)
    and every final leaf equal to the JAX fleet's."""
    kw = dict(n=N, k=K, suspect_ticks=6, rng="counter")
    names = ("churn", "flap", "asym")
    jplan = jc.stack_plans([jc.scenario_plan(s, N, seed=i, horizon=32) for i, s in enumerate(names)])
    tplan = tc.stack_plans([tc.scenario_plan(s, N, seed=i, horizon=32, device=CPU) for i, s in enumerate(names)])
    jmc = jm.MonteCarlo(jl.LifecycleParams(**kw), SEEDS[:3], telemetry=True)
    tmc = tm.MonteCarlo(tl.LifecycleParams(**kw), SEEDS[:3], telemetry=True, device=CPU)
    want, got = [], []
    for _ in range(2):
        jmc.run(16, jplan)
        want += jmc.fetch_telemetry(jplan, id_base=10)
        tmc.run(16, tplan)
        got += tmc.fetch_telemetry(tplan, id_base=10)
    assert [r["scenario_id"] for r in got[:3]] == [10, 11, 12]
    assert_records_equal(got, want)
    assert sum(r["decl_suspect"] for r in want) > 0
    assert_states_equal(jmc.states, tmc.states, "stacked plan")
    tel = tmc.telemetry
    assert tel.pings.shape == (3, N) and not tel.pings.any() and tel.suspects_by_tier is None


def test_b1_fleet_is_the_solo_engine_under_a_chaos_plan():
    """``mc_smoke``'s first leg: a one-member stacked plan through the fleet
    with telemetry ends bit-identical, state digest and block records, to
    the plan through the solo ``LifecycleSim`` chaos path."""
    kw = dict(k=K, suspect_ticks=6, rng="counter")
    plan = tc.scenario_plan("smoke", N, seed=0, horizon=32, device=CPU)
    b1 = tc.stack_plans([plan])
    mc = tm.MonteCarlo(tl.LifecycleParams(n=N, **kw), [0], telemetry=True, device=CPU)
    fleet = []
    for _ in range(2):
        mc.run(16, b1)
        fleet += mc.fetch_telemetry(b1)
    sink = tt.TelemetrySink()
    sim = tl.LifecycleSim(n=N, seed=0, telemetry=sink, device=CPU, **kw)
    for _ in range(2):
        sim.run(16, plan)
    assert fleet[-1]["state_digest"] == int(tt.tree_digest(sim.state))
    for got, want in zip(fleet, sink.records):
        assert {k: v for k, v in got.items() if k != "scenario_id"} == want


def test_states_setter_round_trips_and_refuses_another_b():
    tmc = tm.MonteCarlo(tl.LifecycleParams(n=N, k=K), SEEDS, device=CPU)
    tmc.run(2)
    saved = tmc.states
    tmc.run(2)
    tmc.states = saved
    assert_states_equal(jl.LifecycleState(*tl.state_to_numpy(saved)), tmc.states)
    with pytest.raises(ValueError, match="B=2"):
        tmc.states = tl.LifecycleState(*(x[:2] for x in saved))
    tmc.reset_states([1, 2, 3, 4])
    assert tmc.seeds == [1, 2, 3, 4] and tmc.states.tick.tolist() == [0] * 4
    with pytest.raises(ValueError, match="3 seeds"):
        tmc.reset_states([1, 2, 3])


def test_unported_routes_refuse_by_queue_item(monkeypatch, tmp_path):
    """The AOT warm start (A15) now runs: a tagged fleet's detection program
    goes through the front door, bit-equal to the JAX package's with aot=
    on, one program with the JAX package's record keys.  The fleet meshes
    (A12b) run: on one process the fleet mesh is (1, 1, 1) and the fleet on it is
    the unsharded fleet (the multi-rank meshes are in
    tests/test_torch_fleet_mesh.py)."""
    from ringpop_tpu_torch.parallel.partition import P

    params = tl.LifecycleParams(n=N, k=K)
    monkeypatch.setenv("RINGPOP_TPU_AOT_CACHE", str(tmp_path))
    up = up_mask()
    jmc = jm.MonteCarlo(jl.LifecycleParams(n=N, k=K, suspect_ticks=SUSPECT), SEEDS, aot="tag")
    tmc = tm.MonteCarlo(tl.LifecycleParams(n=N, k=K, suspect_ticks=SUSPECT), SEEDS, aot="tag", device=CPU)
    want = jmc.run_until_detected(VICTIMS, jd.DeltaFaults(up=jnp.asarray(up)), max_ticks=64, check_every=4)
    got = tmc.run_until_detected(VICTIMS, td.DeltaFaults(up=torch.from_numpy(up)), max_ticks=64, check_every=4)
    assert want[1].all() and all(np.array_equal(g, w) for g, w in zip(got, want))
    assert_states_equal(jmc.states, tmc.states, "aot")
    assert [tag.rsplit("-f", 1)[0] for tag in tmc.aot_info] == [tag.rsplit("-f", 1)[0] for tag in jmc.aot_info] \
        == ["tag-mc4"]
    (tinfo,), (jinfo,) = tmc.aot_info.values(), jmc.aot_info.values()
    assert set(tinfo) == set(jinfo) and tinfo["error"] is None and tinfo["saved"]
    mesh = tm.make_fleet_mesh(device="cpu")
    assert mesh.shape == {"batch": 1, "node": 1, "rumor": 1} == tm.fleet_save_mesh(device="cpu").shape
    on_mesh, plain = tm.MonteCarlo(params, SEEDS, mesh=mesh), tm.MonteCarlo(params, SEEDS, device=CPU)
    assert on_mesh.device == CPU
    assert_states_equal(jl.LifecycleState(*tl.state_to_numpy(on_mesh.run(3))), plain.run(3))
    assert on_mesh.digests() == plain.digests()
    assert all(torch.equal(a, b) for a, b in zip(tm.init_replicas(params, SEEDS, mesh=mesh),
                                                 tm.init_replicas(params, SEEDS, device=CPU)))
    specs = tm.fleet_state_shardings(mesh, k=K)
    assert specs.pcount.spec == P("batch", "node", "rumor") and specs.tick.spec == P("batch")
    assert tm.fleet_shardings({"x": 0}, mesh)["x"].spec == P("batch")
    legs = tm.fleet_faults_shardings(td.DeltaFaults(up=torch.ones(4, N, dtype=torch.bool),
                                                    drop_rate=torch.tensor(0.1)), mesh)
    assert legs.up.spec == P("batch", "node") and legs.drop_rate.spec == P() and legs.reach is None
    with pytest.raises(ValueError, match="need 2 ranks"):
        tm.make_fleet_mesh(2)
    with pytest.raises(ValueError, match="telemetry=True"):
        tm.MonteCarlo(params, SEEDS, device=CPU).fetch_telemetry()


def test_fleet_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.MonteCarlo(tl.LifecycleParams(n=N, k=K), SEEDS)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init_replicas(tl.LifecycleParams(n=N, k=K), SEEDS)
