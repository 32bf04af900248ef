"""The lifecycle engine's entry points and run loops: PyTorch port against the
JAX package.

``bench.py``'s BENCH_FAST configuration (20,000 x 64, 5 victims) through
detection and convergence with the queries on the way; churn (crash,
revive, eviction, ``admit`` of an evicted node); a run resumed from a JAX
state; the run-until pair's tick counts with the time-budget and
zero-budget paths; the refusals, the entry points without a card, the
launchers' refusal of CPU tensors and the launch counts.  Apart from
``tests/test_torch_lifecycle.py`` (every leaf at every tick) so that the
test scheduler can run the two on different workers.  The tolerance is
none.
"""

import jax
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import lifecycle as jl

from ringpop_tpu_torch.ops import lifecycle_kernel as lk
from ringpop_tpu_torch.parallel.mesh import Mesh
from ringpop_tpu_torch.parallel.partition import P, NamedSharding
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim import telemetry as tt
from test_torch_lifecycle import _assert_same_queries, _faults, _jstep, _pair, _run_both, _victims, assert_same_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bench_fast_config_detects_like_jax():
    """bench.py's BENCH_FAST lifecycle configuration (20,000 x 64, 5
    victims, bench.py:411): every leaf at every tick through detection, the
    queries on the way, then ``run_until_detected(check_every=32)`` from a
    fresh state detects at tick 64 in both packages, and
    ``run_until_converged`` agrees after it."""
    n, k = 20_000, 64
    victims = _victims(n, 5)
    jp, tp = _pair(n, k)
    jf, tf = _faults("", n, victims, seed=0)

    def every(t, js, ts):
        if t % 32 == 0:
            _assert_same_queries(js, ts, jf, tf, victims, f"tick {t}")

    _run_both(jp, tp, jf, tf, 64, every=every)
    jsim = jl.LifecycleSim(n=n, k=k, seed=0, rng="counter")
    tsim = tl.LifecycleSim(n=n, k=k, seed=0, rng="counter", device="cpu")
    kw = dict(max_ticks=4096, check_every=32, blocks_per_dispatch=8)
    got = tsim.run_until_detected(victims, tf, **kw)
    assert got == jsim.run_until_detected(victims, jf, **kw) == (64, True)
    assert_same_state(jsim.state, tsim.state, "detected")
    assert tsim.run_until_converged(tf, **kw) == jsim.run_until_converged(jf, **kw)
    assert_same_state(jsim.state, tsim.state, "converged")
    assert np.array_equal(np.asarray(jl.view_checksums(jsim.state, jf)).astype(np.int64),
                          tl.view_checksums(tsim.state, tf).numpy())


def test_churn_crash_revive_evict_admit():
    """4096 x 32 under churn: 12 nodes crash and go through Suspect,
    Faulty and Tombstone to eviction; half revive (refuting by
    reincarnation); an evicted node is admitted again.  Every leaf at every
    tick, and every query at each phase change."""
    n, k = 4096, 32
    jp, tp = _pair(n, k, suspect_ticks=3, faulty_ticks=5, tombstone_ticks=4, alloc_per_tick=16)
    victims = _victims(n, 12, seed=5)
    jf, tf = _faults("", n, victims, seed=5)
    js, ts = _run_both(jp, tp, jf, tf, 40, seed=5)
    evicted = ~np.asarray(js.base_present)
    assert evicted[victims].any(), "no victim reached eviction: the churn case lost its coverage"
    _assert_same_queries(js, ts, jf, tf, victims[:6], "crashed")
    # half the victims revive
    jf2, tf2 = _faults("", n, victims[::2], seed=5)
    js, ts = _run_both(jp, tp, jf2, tf2, 12, js=js, ts=ts)
    _assert_same_queries(js, ts, jf2, tf2, victims[:6], "revived")
    # admit an evicted, now live node
    back = int(victims[1]) if evicted[victims[1]] else int(victims[np.flatnonzero(evicted[victims])[0]])
    jf3, tf3 = _faults("", n, [v for v in victims[::2] if v != back], seed=5)
    js = jl.admit(jp, js, back)
    ts = tl.admit(tp, ts, back)
    assert_same_state(js, ts, "admit")
    js, ts = _run_both(jp, tp, jf3, tf3, 20, js=js, ts=ts)
    assert bool(np.asarray(js.base_present)[back])
    _assert_same_queries(js, ts, jf3, tf3, [back, *victims[:4]], "admitted")


def test_resume_from_a_mid_run_jax_state():
    """A JAX state after 11 ticks crosses with ``state_from_numpy`` (uint32
    planes as int32 bit patterns, the key as int64) and both engines go on
    in step; ``state_to_numpy`` gives the JAX dtypes back."""
    for exchange in ("shift", "uniform"):
        jp, tp = _pair(4096, 40, exchange, suspect_ticks=4)
        jf, tf = _faults("drop", 4096, _victims(4096, 10), seed=3)
        js = jl.init_state(jp, seed=42)
        jstep = _jstep(jp)
        for _ in range(11):
            js = jstep(js, jf)
        ts = tl.state_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")
        assert ts.learned.dtype == torch.int32 and ts.key.dtype == torch.int64
        assert [a.dtype for a in tl.state_to_numpy(ts)] == [np.asarray(a).dtype for a in js]
        _run_both(jp, tp, jf, tf, 10, js=js, ts=ts)


def test_run_until_tick_counts_and_budgets():
    """``run_until_detected``/``run_until_converged`` report the JAX
    package's tick counts: plain, with a generous time budget (one block
    first, then adaptive dispatches), with a zero time budget (one block,
    then stop), with a zero tick budget (the entry check alone), and on an
    already detected state (0 ticks)."""
    n, k = 2048, 32
    victims = _victims(n, 8, seed=2)
    jf, tf = _faults("drop", n, victims, seed=2)
    kw = dict(suspect_ticks=4, rng="counter")
    for budget, max_ticks in ((None, 4096), (1e9, 4096), (0.0, 4096), (None, 0), (None, 20)):
        jsim = jl.LifecycleSim(n=n, k=k, seed=7, **kw)
        tsim = tl.LifecycleSim(n=n, k=k, seed=7, device="cpu", **kw)
        run = dict(max_ticks=max_ticks, check_every=8, blocks_per_dispatch=3, time_budget_s=budget)
        got = tsim.run_until_detected(victims, tf, **run)
        want = jsim.run_until_detected(victims, jf, **run)
        assert got == want, (budget, max_ticks)
        assert_same_state(jsim.state, tsim.state, f"detected {budget} {max_ticks}")
        if budget is None and max_ticks == 4096:
            assert got[1] and got[0] > 0
            assert tsim.run_until_detected(victims, tf, **run) == (0, True)
            got = tsim.run_until_converged(tf, max_ticks=4096, check_every=4)
            assert got == jsim.run_until_converged(jf, max_ticks=4096, check_every=4)
            assert_same_state(jsim.state, tsim.state, "converged")
    jsim.run(5, jf)
    tsim.run(5, tf)
    jsim.tick(jf)
    tsim.tick(tf)
    assert_same_state(jsim.state, tsim.state, "run + tick")


def _cpu_mesh(size, rumor=1):
    """A mesh object of ``size`` node ranks by ``rumor`` rumor ranks, this
    process at (0, 0): enough for the checks that refuse before any
    collective."""
    return Mesh(size=size, rank=0, device=torch.device("cpu"), transport="gloo", rumor_size=rumor)


def test_refusals_name_their_roadmap_item():
    default = tl.LifecycleParams(n=64, k=32)
    assert default.rng == "threefry"  # the JAX default, kept so a call means the same
    # the default stream runs: step and LifecycleSim match the JAX package's
    jdefault = jl.LifecycleParams(n=64, k=32)
    assert_same_state(jl.step(jdefault, jl.init_state(jdefault)),
                      tl.step(default, tl.init_state(default, device="cpu")), "threefry step")
    jsim, tsim = jl.LifecycleSim(64, k=32), tl.LifecycleSim(64, k=32, device="cpu")
    assert_same_state(jsim.run(3), tsim.run(3), "LifecycleSim")
    jf, tf = _faults("tier", 64, [], seed=1)
    for step in (lambda: jl.step(jdefault, jl.init_state(jdefault), jf),
                 lambda: tl.step(default, tl.init_state(default, device="cpu"), tf)):
        with pytest.raises(ValueError, match="tier legs need rng='counter'"):
            step()
    with pytest.raises(ValueError, match="rng"):
        tl.LifecycleSim(64, k=32, rng="philox", device="cpu")
    counter = tl.LifecycleParams(n=64, k=32, rng="counter")
    state = tl.init_state(counter, device="cpu")
    # the sharded exchange (A12) and the rumor axis with telemetry under a
    # mesh (A12b) are ported: ranks that do not divide n are refused, and so
    # is a k that does not shard over the rumor axis (the JAX package's
    # ValueError); a mesh's accumulator is the rank's block
    # (tests/test_torch_sharded.py and tests/test_torch_rumor_axis*.py run
    # the ranks)
    with pytest.raises(ValueError, match="must divide"):
        tl.step(tl.LifecycleParams(n=64, k=32, rng="counter", exchange_mesh=_cpu_mesh(3)), state)
    with pytest.raises(ValueError, match="cannot shard over a 2-way rumor axis"):
        tl.step(tl.LifecycleParams(n=64, k=32, rng="counter", exchange_mesh=_cpu_mesh(1, rumor=2)), state,
                telemetry=tt.zeros(counter, device="cpu"))
    block = tt.zeros(tl.LifecycleParams(n=64, k=64, rng="counter", exchange_mesh=_cpu_mesh(2, rumor=2)),
                     device="cpu")
    assert block.pings.shape == (32,) and block.piggybacked.shape == (32, 1) and block.timer_fires.shape == (64,)
    # telemetry (A7) is ported: a step with an accumulator returns the pair
    out, tel = tl.step(counter, state, telemetry=tt.zeros(counter, device="cpu"))
    assert int(tel.ticks) == 1 and torch.equal(out.learned, tl.step(counter, state).learned)
    assert tl.LifecycleSim(64, k=32, rng="counter", telemetry=True, device="cpu").telemetry is not None
    with pytest.raises(NotImplementedError, match="A15"):
        tl.LifecycleSim(64, k=32, rng="counter", aot="tag", device="cpu")
    # learned_sharding (A12) is a route hint: over one node rank it changes nothing
    hint = NamedSharding(_cpu_mesh(1), P("node", None))
    sim = tl.LifecycleSim(64, k=32, rng="counter", device="cpu")
    plain = tl.LifecycleSim(64, k=32, rng="counter", device="cpu")
    assert sim.run_until_detected([1], learned_sharding=hint) == plain.run_until_detected([1])
    assert torch.equal(sim.state.learned, plain.state.learned)
    assert bool(tl.detection_complete(state, [1], learned_sharding=hint)) == bool(tl.detection_complete(state, [1]))
    with pytest.raises(ValueError, match="column span"):
        tl.step(tl.LifecycleParams(n=64, k=32, rng="counter", ping_req_size=256), state)


def test_init_state_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = tl.LifecycleParams(n=64, k=32, rng="counter")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.init_state(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.LifecycleSim(64, k=32, rng="counter")
    assert tl.init_state(params, device="cpu").learned.device.type == "cpu"


@pytest.mark.parametrize("call", [
    lambda p: lk.slot_walk_cuda(p, torch.zeros(4, dtype=torch.int64, device=p.device),
                                torch.zeros(4, dtype=torch.int32, device=p.device),
                                torch.zeros(4, dtype=torch.int32, device=p.device),
                                torch.zeros(p.shape[0], dtype=torch.int32, device=p.device), "checksum"),
    lambda p: lk.first_live_learner_cuda(p, None, 40),
])
def test_launchers_refuse_non_cuda_and_never_fall_back(call, monkeypatch, tmp_path):
    """A CPU tensor is refused by the launcher; a tensor that is not on the
    CPU goes to the kernel, never to the plain version: here (no card, no
    nvcc) that is an error.  A meta tensor stands in for a CUDA one."""
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros((4, 2), dtype=torch.int32))
    p = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        call(p)
    monkeypatch.setattr(lk, "_require_cuda", lambda t, what: None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(lk, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(lk, "_lib", None)
    before = dict(lk.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        call(p)
    assert lk.launches == before
    assert not (tmp_path / "build").exists()


def test_reset_launches():
    lk.launches["slot_walk"] = 3
    lk.launches["first_live_learner"] = 2
    lk.reset_launches()
    assert lk.launches == {"slot_walk": 0, "first_live_learner": 0}
