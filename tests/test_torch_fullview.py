"""The port's exact full-view engine against the JAX package's, bit for bit.

``ringpop_tpu_torch.sim.fullview`` on the CPU (the plain PyTorch path:
F1's plain version ``ops/fullview_kernel.apply_plain``, the plain masked
categorical and threefry draws) against ``ringpop_tpu.sim.fullview``:
every leaf equal after every tick of free-running engines on their own
threefry draws (crashes, partitions, loss at 10 %), from ``init_state`` and
from a JAX mid-run state carried across with ``state_from_numpy``; F1's
plain version against the JAX ``_apply_batch`` on random states and
candidate batches; ``maxP``'s integer digit count against the JAX float32
expression for every count 0..2**20; the fault coercion's refusals; the
launcher's arguments and its refusal of CPU tensors.  The tolerance is
none.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import fullview as jfv
from ringpop_tpu.sim.delta import DeltaFaults as JDeltaFaults
from ringpop_tpu_torch.ops import fullview_kernel as fk
from ringpop_tpu_torch.ops import threefry_kernel as tk
from ringpop_tpu_torch.sim import fullview as tfv
from ringpop_tpu_torch.sim.delta import DeltaFaults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TIMEOUTS = dict(suspect_ticks=5, faulty_ticks=20, tombstone_ticks=6)


def _assert_equal(jstate, tstate, what):
    got = tfv.state_to_numpy(tstate)
    for name, a, b in zip(jfv.FullViewState._fields, jstate, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (what, name, np.argwhere(a != b)[:5].tolist())


def _faults(n, seed, down=(), groups=0, drop=0.0):
    up = np.ones(n, bool)
    up[list(down)] = False
    group = None
    if groups:
        group = (np.arange(n) * groups // n).astype(np.int32)
        group[np.random.default_rng(seed).choice(n, 3, replace=False)] = -1
    jf = jfv.Faults(up=jnp.asarray(up), group=None if group is None else jnp.asarray(group), drop_rate=drop)
    tf = tfv.Faults(up=torch.as_tensor(up), group=None if group is None else torch.as_tensor(group),
                    drop_rate=drop)
    return jf, tf


# the engine-agreement shapes (tests/engine_agreement.py): 256 nodes, loss at
# 10 %, a partition, crashes
FREE_RUNS = {
    "drop_and_partition": dict(n=256, seed=11, down=(), groups=2, drop=0.10),
    "crashes_and_drop": dict(n=256, seed=12, down=(3, 77, 200), groups=0, drop=0.10),
    "crashes_partition_no_drop": dict(n=96, seed=13, down=(5, 50), groups=3, drop=0.0),
}


@pytest.mark.parametrize("run", sorted(FREE_RUNS))
def test_free_running_engine_matches_jax_every_tick(run):
    cfg = FREE_RUNS[run]
    n, seed = cfg["n"], cfg["seed"]
    jsim = jfv.FullViewSim(n=n, seed=seed, **TIMEOUTS)
    tsim = tfv.FullViewSim(n=n, seed=seed, device="cpu", **TIMEOUTS)
    jf, tf = _faults(n, seed, cfg["down"], cfg["groups"], cfg["drop"])
    _assert_equal(jsim.state, tsim.state, "init")
    for t in range(30):
        jsim.tick(jf)
        tsim.tick(tf)
        _assert_equal(jsim.state, tsim.state, f"{run} tick {t + 1}")
    # not a vacuous run: suspicions were raised and spread
    assert (tfv.state_to_numpy(tsim.state).status != 0).any()
    assert tsim.views_converged() == jsim.views_converged()
    assert tsim.has_changes() == jsim.has_changes()
    assert np.array_equal(tsim.status_matrix(), jsim.status_matrix())


def test_engine_continues_from_a_jax_mid_run_state():
    n, seed = 128, 21
    jsim = jfv.FullViewSim(n=n, seed=seed, **TIMEOUTS)
    jf, tf = _faults(n, seed, down=(1, 2, 90), groups=2, drop=0.05)
    for _ in range(9):
        jsim.tick(jf)
    tsim = tfv.FullViewSim(n=n, seed=0, device="cpu", **TIMEOUTS)
    tsim.state = tfv.state_from_numpy(tsim.params, jax.tree_util.tree_map(np.asarray, jsim.state), device="cpu")
    for t in range(12):
        jsim.tick(jf)
        tsim.tick(tf)
        _assert_equal(jsim.state, tsim.state, f"tick {t + 10}")


def test_unconverged_start_and_injected_draws_match_jax():
    """A cluster that starts knowing only itself, with injected targets and
    peers of every shape the harness gives (a pool of none included)."""
    n = 40
    jsim = jfv.FullViewSim(n=n, seed=3, converged=False, **TIMEOUTS)
    tsim = tfv.FullViewSim(n=n, seed=3, converged=False, device="cpu", **TIMEOUTS)
    rng = np.random.default_rng(5)
    for t in range(15):
        targets = rng.integers(0, n, n).astype(np.int32)
        peers = rng.integers(0, n, (n, 3)).astype(np.int32)
        jsim.tick(targets=jnp.asarray(targets), peers=jnp.asarray(peers))
        tsim.tick(targets=torch.as_tensor(targets), peers=torch.as_tensor(peers))
        _assert_equal(jsim.state, tsim.state, f"tick {t + 1}")


def test_state_round_trips():
    p = tfv.FullViewParams(n=17)
    jsim = jfv.FullViewSim(n=17, seed=9, **TIMEOUTS)
    jf, _ = _faults(17, 9, down=(4,), drop=0.2)
    for _ in range(6):
        jsim.tick(jf)
    arrays = jax.tree_util.tree_map(np.asarray, jsim.state)
    state = tfv.state_from_numpy(p, arrays, device="cpu")
    assert [t.dtype for t in state] == [torch.int8, torch.int32, torch.bool, torch.bool, torch.int32, torch.int8,
                                        torch.int32, torch.int32, torch.int64]
    _assert_equal(arrays, state, "round trip")
    back = tfv.state_to_numpy(state)
    assert back.key.dtype == np.uint32 and back.tick.shape == ()
    _assert_equal(arrays, tfv.state_from_numpy(p, back, device="cpu"), "second round trip")
    tfv.step(p, state)
    _assert_equal(arrays, state, "step left its input as it was")
    with pytest.raises(ValueError, match="shape"):
        tfv.state_from_numpy(tfv.FullViewParams(n=16), arrays, device="cpu")


def test_init_state_matches_jax():
    for converged in (True, False):
        p = tfv.FullViewParams(n=9)
        _assert_equal(jfv.init_state(jfv.FullViewParams(n=9), seed=2**32 - 3, converged=converged),
                      tfv.init_state(p, seed=2**32 - 3, converged=converged, device="cpu"), converged)


def test_max_p_matches_the_float32_expression_for_every_count():
    num = np.arange(2**20 + 1, dtype=np.int32)
    want = np.asarray((15 * jnp.ceil(jnp.log10(jnp.asarray(num).astype(jnp.float32) + 1.0))).astype(jnp.int32))
    got = (15 * tfv.decimal_digits(torch.as_tensor(num))).to(torch.int32).numpy()
    assert np.array_equal(want, got)
    assert np.array_equal(tfv.decimal_digits(num), [len(str(x)) if x else 0 for x in num.tolist()])
    big = np.array([10**9 - 1, 10**9, 2**31 - 1], np.int64)
    assert tfv.decimal_digits(big).tolist() == [9, 10, 10]


def test_max_p_of_a_state_matches_jax():
    n = 50
    rng = np.random.default_rng(4)
    status = rng.integers(0, 5, (n, n)).astype(np.int8)
    present = rng.random((n, n)) < 0.8
    want = jfv._max_p(jfv.FullViewParams(n=n), jnp.asarray(status), jnp.asarray(present), jnp.eye(n, dtype=bool))
    got = tfv._max_p(tfv.FullViewParams(n=n), torch.as_tensor(status), torch.as_tensor(present))
    assert got.dtype == torch.int32 and np.array_equal(np.asarray(want), got.numpy())


def _random_state(n, seed):
    """A state with every status, pending -1..4, deadlines around the tick,
    incarnations with ties, absent cells, and the diagonal included."""
    rng = np.random.default_rng(seed)
    tick = 37
    return jfv.FullViewState(
        status=rng.integers(0, 5, (n, n)).astype(np.int8),
        incarnation=rng.integers(0, 6, (n, n)).astype(np.int32) * 200,
        present=rng.random((n, n)) < 0.7,
        has_change=rng.random((n, n)) < 0.4,
        pcount=rng.integers(0, 40, (n, n)).astype(np.int32),
        pending=rng.integers(-1, 5, (n, n)).astype(np.int8),
        deadline=rng.integers(tick - 5, tick + 30, (n, n)).astype(np.int32),
        tick=np.int32(tick),
        key=np.array([0, seed], np.uint32),
    )


def _random_candidates(state, seed, density):
    """Candidate keys (-1 none) at incarnations near each cell's own, so
    that wins, losses, ties, refutations and first-seen tombstones all
    occur."""
    rng = np.random.default_rng(seed + 1000)
    n = state.status.shape[0]
    inc = np.maximum(state.incarnation + rng.integers(-1, 2, (n, n)).astype(np.int32) * 200, 0)
    cand = (inc << 3) | rng.integers(0, 5, (n, n)).astype(np.int32)
    return np.where(rng.random((n, n)) < density, cand, -1).astype(np.int32)


@pytest.mark.parametrize("seed", range(6))
def test_apply_plain_matches_jax_apply_batch(seed):
    n = 64
    params = tfv.FullViewParams(n=n, **TIMEOUTS)
    jstate = _random_state(n, seed)
    cand = _random_candidates(jstate, seed, (0.05, 0.5, 1.0)[seed % 3])
    now = np.int32(1234)
    want, applied = jfv._apply_batch(
        jfv.FullViewParams(n=n, **TIMEOUTS), jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(cand),
        jnp.asarray(cand >= 0), jnp.asarray(now), jnp.eye(n, dtype=bool))
    assert 0 < int(applied.sum()) < n * n or seed % 3 == 0
    state = tfv.state_from_numpy(params, jstate, device="cpu")
    fk.apply_plain(state[:7], torch.as_tensor(cand), state.tick, torch.tensor(now), (5, 20, 6))
    _assert_equal(want, state, f"seed {seed}")
    # through the engine's own entry point too
    state = tfv.state_from_numpy(params, jstate, device="cpu")
    tfv._apply_batch(params, state, torch.as_tensor(cand), torch.tensor(now))
    _assert_equal(want, state, f"seed {seed}, _apply_batch")


def test_fire_timers_match_jax():
    n = 48
    for seed in range(3):
        jstate = _random_state(n, seed)
        jparams = jfv.FullViewParams(n=n, **TIMEOUTS)
        now = np.int32(7600)
        want = jfv._fire_timers(jparams, jax.tree_util.tree_map(jnp.asarray, jstate), jnp.asarray(now),
                                jnp.eye(n, dtype=bool))
        params = tfv.FullViewParams(n=n, **TIMEOUTS)
        state = tfv.state_from_numpy(params, jstate, device="cpu")
        tfv._fire_timers(params, state, torch.tensor(now))
        _assert_equal(want, state, f"seed {seed}")


def test_tick_refuses_an_incarnation_past_the_key_limit():
    """A change key is ``(incarnation << 3) | state`` >= 0 in int32, so the
    tick whose refutation ms would reach 2**28 is refused, not run wrong."""
    assert tfv.MAX_INCARNATION == 2**28
    sim = tfv.FullViewSim(n=4, device="cpu")
    last = -(-tfv.MAX_INCARNATION // sim.params.tick_ms) - 2  # (last + 1) * tick_ms < 2**28
    sim.state = sim.state._replace(tick=torch.tensor(last, dtype=torch.int32))
    sim.tick()
    assert int(sim.state.tick) == last + 1
    with pytest.raises(OverflowError, match="limit 268435456"):
        sim.tick()
    assert int(sim.state.tick) == last + 1


@pytest.mark.parametrize("faults,match", [
    (DeltaFaults(reach=torch.ones(2, 2, dtype=torch.bool)), "directed reach"),
    (DeltaFaults(drop_node=torch.zeros(4)), "per-node drop"),
    (DeltaFaults(tier_ids=torch.zeros(3, 4, dtype=torch.int32), tier_drop=torch.zeros(4)), "topology tier legs"),
    (DeltaFaults(suspect_ticks=torch.tensor(3)), "suspect_ticks"),
    (types.SimpleNamespace(at_tick=lambda t: None, up=None, group=None), "FaultPlan"),
], ids=["reach", "drop_node", "tiers", "suspect_ticks", "plan"])
def test_as_fullview_faults_refuses_what_fullview_cannot_express(faults, match):
    with pytest.raises((ValueError, TypeError), match=match) as port_err:
        tfv.as_fullview_faults(faults)
    # the JAX package refuses the same legs with the same message
    legs = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
            for k, v in vars(faults).items() if v is not None}
    jfaults = faults if "at_tick" in legs else JDeltaFaults(**legs)
    with pytest.raises(port_err.type, match=match) as jax_err:
        jfv.as_fullview_faults(jfaults)
    assert str(jax_err.value) == str(port_err.value)


def test_as_fullview_faults_moves_legs_and_keeps_the_rate_static():
    up = np.array([True, False, True])
    f = tfv.as_fullview_faults(DeltaFaults(up=up, group=np.array([0, 1, -1]), drop_rate=np.float32(0.05)),
                               device="cpu")
    assert f.up.dtype == torch.bool and f.group.dtype == torch.int32 and isinstance(f.drop_rate, float)
    assert f.drop_rate == float(np.float32(0.05))
    assert tfv.as_fullview_faults(DeltaFaults()).drop_rate == 0.0
    assert tfv.as_fullview_faults(tfv.Faults(drop_rate=0.1)) == tfv.Faults(drop_rate=0.1)


def test_entry_points_raise_without_a_card(monkeypatch):
    from ringpop_tpu_torch.sim.conformance import LockstepRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda device: tfv.FullViewSim(n=4, device=device),
                 lambda device: LockstepRunner(n=4, device=device),
                 lambda device: tfv.init_state(tfv.FullViewParams(n=4), device=device)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        call("cpu")


def _stub_library(monkeypatch, calls):
    monkeypatch.setattr(fk, "_library", lambda: types.SimpleNamespace(
        rp_fullview_apply=lambda *args: calls.append(args) or 0))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))


def test_apply_launcher_passes_planes_scalars_and_timeouts(monkeypatch):
    """The launcher hands the kernel the candidates, the seven planes in
    field order, the tick and now_ms scalars, n and the three timeouts; a
    stub library stands in for the built one and meta tensors for CUDA
    ones (their check is the one step patched out)."""
    calls = []
    _stub_library(monkeypatch, calls)
    n = 6
    state = tfv.init_state(tfv.FullViewParams(n=n), device="cpu")
    planes = [t.to("meta") for t in state[:7]]
    cand = torch.empty((n, n), dtype=torch.int32, device="meta")
    tick, now = torch.empty((), dtype=torch.int32, device="meta"), torch.empty((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fk.apply_cuda(planes, cand, tick, now, (5, 20, 6))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    before = fk.launches["apply"]
    fk.apply_cuda(planes, cand, tick, now, (5, 20, 6))
    assert fk.launches["apply"] == before + 1
    (args,) = calls
    assert len(args) == 19 and args[10:] == (n, *tk.reciprocal(n), 5, 20, 6, 0)
    with pytest.raises(ValueError, match="int32"):
        fk.apply_cuda(planes[:1] + [planes[1].to(torch.int64)] + planes[2:], cand, tick, now, (5, 20, 6))
    with pytest.raises(ValueError, match="scalars"):
        fk.apply_cuda(planes, cand, tick.to(torch.int64), now, (5, 20, 6))


def test_apply_goes_by_device_and_never_falls_back(monkeypatch, tmp_path):
    """A CPU batch takes the plain version; one off the CPU goes to the
    kernel, never to the plain version: here (no card, no nvcc) that is an
    error, and nothing is counted."""
    n = 3
    state = tfv.init_state(tfv.FullViewParams(n=n), device="cpu")
    seen = []
    monkeypatch.setattr(fk, "apply_cuda", lambda *a: seen.append("kernel"))
    fk.apply(state[:7], torch.full((n, n), -1, dtype=torch.int32), state.tick, state.tick, (1, 2, 3))
    assert seen == []
    meta = [t.to("meta") for t in state[:7]]
    fk.apply(meta, torch.empty((n, n), dtype=torch.int32, device="meta"), state.tick, state.tick, (1, 2, 3))
    assert seen == ["kernel"]
    monkeypatch.undo()
    monkeypatch.setattr(fk, "_check", lambda *a: n)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(fk, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(fk, "_lib", None)
    before = dict(fk.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        fk.apply(meta, torch.empty((n, n), dtype=torch.int32, device="meta"), state.tick, state.tick, (1, 2, 3))
    assert fk.launches == before
    fk.reset_launches()
    assert fk.launches == {"apply": 0}
