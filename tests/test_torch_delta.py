"""The delta-dissemination engine: PyTorch port against the JAX package.

Every leaf of the port's ``DeltaState`` equals ``ringpop_tpu.sim.delta``'s
at every tick, at ``rng="counter"``, on the CPU: n in {4096, 50,000}, k in
{40, 64, 128}, both exchanges, with and without ``up``, ``drop_rate``,
``drop_node``, ``group``/``reach`` and the topology tier legs; a run resumed
from a JAX state in mid-run (``state_from_numpy``); ``converged``;
``converged_fraction`` within 1e-6 relative (both sum float32 per-row
counts, in different orders, over more than 2**24 bits).  The run loops
are in ``tests/test_torch_delta_runs.py`` and ``bench.py``'s full 1,000,000
x 128 configuration in ``tests/test_torch_delta_full_scale.py``.  At
``rng="threefry"``, the default (``tests/test_torch_golden.py`` holds the
small configurations to the frozen goldens): both exchanges with ``up`` and
``drop_rate`` at 4096 and 50,000 nodes, and the default parameters through
``step``, ``run_until_converged`` and ``DeltaSim``.  Also the refusals
(``exchange_mesh``, the topology legs under threefry; ``telemetry_sink``
now journals)
and the hazards the port meets:
``%`` against ``fmod`` for the shift's index, the int8 ``pcount + bump``
at the cap, ``scatter_reduce_`` over duplicate targets, and the float32
order of the survival product.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim.packbits import pack_bool

from ringpop_tpu_torch.parallel.mesh import Mesh
from ringpop_tpu_torch.sim import delta as td


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIELDS = jd.DeltaState._fields


def assert_same_state(js, ts, where=""):
    tn = td.state_to_numpy(ts)
    for name, a, b in zip(FIELDS, js, tn):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, name)


def _faults(kind, n, seed):
    """(JAX DeltaFaults, port DeltaFaults) for a named fault mix."""
    rng = np.random.default_rng(seed)
    legs = {}
    if "up" in kind:
        up = np.ones(n, bool)
        up[rng.choice(n, max(1, n // 50), replace=False)] = False
        legs["up"] = up
    if "drop" in kind:
        legs["drop_rate"] = np.float32(0.05)
    if "node" in kind:
        legs["drop_node"] = (rng.random(n) * 0.2).astype(np.float32)
    if "group" in kind:
        g = rng.integers(-1, 3, size=n).astype(np.int32)
        legs["group"] = g
    if "reach" in kind:
        reach = rng.random((3, 3)) < 0.6
        np.fill_diagonal(reach, True)
        legs["reach"] = reach
    if "tier" in kind:
        ids = np.stack([np.arange(n) // 16, np.arange(n) // 256, np.arange(n) // 1024]).astype(np.int32)
        legs["tier_ids"] = ids
        legs["tier_drop"] = np.array([0.0, 0.02, 0.1, 0.3], np.float32)
    jf = jd.DeltaFaults(**{k: jnp.asarray(v) for k, v in legs.items()})
    return jf, td.faults_from_numpy(jf, device="cpu")


def _pair(n, k, exchange, **kw):
    return (jd.DeltaParams(n=n, k=k, exchange=exchange, rng="counter", **kw),
            td.DeltaParams(n=n, k=k, exchange=exchange, rng="counter", **kw))


def _run_both(jp, tp, jf, tf, ticks, seed=1, js=None, ts=None):
    if js is None:
        js = jd.init_state(jp, seed=seed)
        ts = td.init_state(tp, seed=seed, device="cpu")
    assert_same_state(js, ts, "init")
    jstep = jax.jit(lambda s, f: jd.step(jp, s, f))
    for t in range(ticks):
        js = jstep(js, jf)
        ts = td.step(tp, ts, tf)
        assert_same_state(js, ts, f"tick {t + 1}")
    return js, ts


CONFIGS = [
    # (n, k, exchange, faults, ticks)
    (4096, 40, "shift", "", 20),
    (4096, 40, "uniform", "", 16),
    (4096, 64, "shift", "up drop", 24),
    (4096, 64, "uniform", "up drop", 20),
    (4096, 128, "shift", "node drop", 20),
    (4096, 128, "uniform", "node", 16),
    (4096, 64, "shift", "group", 20),
    (4096, 64, "uniform", "group reach", 16),
    (4096, 40, "shift", "group reach up", 20),
    (4096, 128, "shift", "tier", 20),
    (4096, 40, "uniform", "tier up node drop", 16),
    (50_000, 64, "shift", "up drop", 20),
    (50_000, 128, "uniform", "up drop", 12),
    (50_000, 40, "shift", "", 16),
    (50_000, 128, "shift", "group reach tier node", 16),
]


@pytest.mark.parametrize("n,k,exchange,kind,ticks", CONFIGS)
def test_every_leaf_every_tick_matches_jax(n, k, exchange, kind, ticks):
    jp, tp = _pair(n, k, exchange)
    jf, tf = _faults(kind, n, seed=n + k)
    js, ts = _run_both(jp, tp, jf, tf, ticks)
    assert bool(td.converged(ts, tf)) == bool(jd.converged(js, jf))
    want = float(jd.converged_fraction(js, jf))
    got = td.converged_fraction(ts, tf)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-6 * max(abs(want), 1e-30)


def test_resume_from_a_mid_run_jax_state():
    """A JAX state after 9 ticks crosses with ``state_from_numpy`` (uint32
    planes as int32 bit patterns, the key as int64) and both engines go on
    in step; ``state_to_numpy`` gives the JAX dtypes back."""
    for exchange in ("shift", "uniform"):
        jp, tp = _pair(4096, 64, exchange)
        jf, tf = _faults("up drop", 4096, seed=3)
        js = jd.init_state(jp, seed=42)
        for _ in range(9):
            js = jd.step(jp, js, jf)
        ts = td.state_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")
        assert ts.learned.dtype == torch.int32 and ts.key.dtype == torch.int64 and ts.tick.dtype == torch.int32
        assert [a.dtype for a in td.state_to_numpy(ts)] == [np.uint32, np.int8, np.uint32, np.int32, np.uint32]
        _run_both(jp, tp, jf, tf, 8, js=js, ts=ts)


def test_init_state_sources_and_max_p():
    for n, k, sources in ((100, 40, None), (7, 40, None), (100, 33, np.arange(33) * 3 % 100)):
        jp, tp = _pair(n, k, "shift", max_p=5)
        assert tp.resolved_max_p() == jp.resolved_max_p() == 5
        assert td.clamped_max_p(tp) == jd.clamped_max_p(jp)
        assert_same_state(jd.init_state(jp, 3, sources), td.init_state(tp, 3, sources, device="cpu"))
    for n in (10, 4096, 1_000_000):
        assert td.resolve_max_p(n, 15, None) == jd.resolve_max_p(n, 15, None)
    assert td.clamped_max_p(td.DeltaParams(n=10**9, k=1, p_factor=200)) == td.INT8_SAFE_MAX_P == 126


# -- refusals -----------------------------------------------------------------


def test_refusals_name_their_roadmap_item():
    default = td.DeltaParams(n=64, k=32)
    assert default.rng == "threefry"  # the JAX default, kept so a call means the same
    state = td.init_state(default, device="cpu")
    # the default stream runs: step, the run loop and DeltaSim match the JAX package's
    jdefault = jd.DeltaParams(n=64, k=32)
    assert_same_state(jd.step(jdefault, jd.init_state(jdefault)), td.step(default, state), "threefry step")
    jrun, trun = jd.run_until_converged(jdefault, jd.init_state(jdefault)), td.run_until_converged(default, state)
    assert jrun[1:] == trun[1:]
    assert_same_state(jrun[0], trun[0], "threefry run_until_converged")
    jsim, tsim = jd.DeltaSim(64, 32), td.DeltaSim(64, 32, device="cpu")
    assert_same_state(jsim.tick(), tsim.tick(), "DeltaSim")
    jf, tf = _faults("tier", 64, seed=3)
    for step in (lambda: jd.step(jdefault, jd.init_state(jdefault), jf), lambda: td.step(default, state, tf)):
        with pytest.raises(ValueError, match="tier legs need rng='counter'"):
            step()
    # the sharded exchange (A12) is ported: a mesh of one node rank holds the
    # whole state and steps it as the unsharded engine does; ranks that do
    # not divide n are refused (tests/test_torch_sharded.py runs 2 and 4)
    counter = td.DeltaParams(n=64, k=32, rng="counter")
    one = Mesh(size=1, rank=0, device=torch.device("cpu"), transport="gloo")
    assert torch.equal(td.step(dataclasses.replace(counter, exchange_mesh=one), state).learned,
                       td.step(counter, state).learned)
    three = Mesh(size=3, rank=0, device=torch.device("cpu"), transport="gloo")
    with pytest.raises(ValueError, match="must divide"):
        td.step(dataclasses.replace(counter, exchange_mesh=three), state)
    # the run journal (A7) is ported: a sink takes one record a block
    records = []
    sim = td.DeltaSim(64, 32, rng="counter", telemetry_sink=records.append, device="cpu")
    assert sim.run_until_converged(max_ticks=16, journal_every=8)[0] > 0
    assert records and set(records[0]) == {"tick", "coverage", "digest"}
    with pytest.raises(ValueError, match="unknown rng"):
        td.step(td.DeltaParams(n=64, k=32, rng="philox"), state)


@pytest.mark.parametrize("n,k,exchange,faults,ticks", [
    (4096, 64, "shift", "up drop", 20),
    (4096, 40, "uniform", "up drop", 16),
    (4096, 128, "uniform", "group reach up node", 12),
    (50_000, 64, "uniform", "up drop", 10),
])
def test_threefry_matches_jax(n, k, exchange, faults, ticks):
    """The JAX default stream: the split, the shift or the uniform targets
    and the drop coin are ``jax.random``'s draws, every leaf equal at every
    tick."""
    jp = jd.DeltaParams(n=n, k=k, exchange=exchange)
    tp = td.DeltaParams(n=n, k=k, exchange=exchange)
    assert jp.rng == tp.rng == "threefry"
    jf, tf = _faults(faults, n, seed=n + k)
    _run_both(jp, tp, jf, tf, ticks, seed=5)


def test_state_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = td.DeltaParams(n=64, k=32, rng="counter")
    for call in (lambda d: td.init_state(params, device=d),
                 lambda d: td.DeltaSim(64, 32, rng="counter", device=d),
                 lambda d: td.state_from_numpy(td.state_to_numpy(td.init_state(params, device="cpu")), device=d),
                 lambda d: td.faults_from_numpy(jd.DeltaFaults(up=jnp.ones(64, bool)), device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        call("cpu")


def test_fault_plan_passes_through_at_tick():
    """Any object with ``at_tick`` (``chaos.FaultPlan`` among them) is
    evaluated at the state's tick, as in the JAX package."""
    jp, tp = _pair(512, 40, "shift")
    jf, tf = _faults("up drop", 512, seed=4)

    class Plan:
        def __init__(self, f):
            self.f, self.seen = f, []

        def at_tick(self, tick):
            self.seen.append(int(tick))
            return self.f

    jplan, tplan = Plan(jf), Plan(tf)
    js, ts = jd.init_state(jp, seed=2), td.init_state(tp, seed=2, device="cpu")
    for _ in range(3):
        js, ts = jd.step(jp, js, jplan), td.step(tp, ts, tplan)
    assert_same_state(js, ts)
    assert tplan.seen == jplan.seen == [0, 1, 2]
    assert td.resolve_faults(tf, 0) is tf


def test_tier_legs_come_as_a_pair():
    with pytest.raises(ValueError, match="pair"):
        td.check_tier_legs(td.DeltaFaults(tier_ids=torch.zeros((3, 4), dtype=torch.int32)))
    assert not td.check_tier_legs(td.DeltaFaults())


# -- hazards --------------------------------------------------------------------


def test_shift_index_takes_the_divisors_sign():
    """``(i - s) % n`` must be the floor modulo of ``jnp.mod``: torch's ``%``
    is, ``torch.fmod`` (C's remainder) is not — it goes negative."""
    n = 1000
    i = torch.arange(n)
    for s in (1, 17, 999):
        want = np.mod(np.arange(n) - s, n)
        assert np.array_equal(((i - s) % n).numpy(), want)
        assert np.array_equal(((i - torch.tensor(s, dtype=torch.int32)) % n).numpy(), want)
        assert (torch.fmod(i - s, n) < 0).any()


@pytest.mark.parametrize("exchange", ["shift", "uniform"])
def test_int8_pcount_at_the_cap(exchange):
    """Counters one below the int8-safe cap of 126 take a sender and a
    receiver bump in one tick: 125 + 2 = 127 still fits int8, and the
    result is clamped to 126 as in JAX."""
    n, k = 256, 40
    jp, tp = _pair(n, k, exchange, max_p=500)
    assert td.clamped_max_p(tp) == 126
    js = jd.init_state(jp, seed=1)
    b = np.random.default_rng(0).random((n, k)) < 0.7
    learned = pack_bool(jnp.asarray(b))
    pcount = jnp.full((n, k), 125, jnp.int8)
    js = js._replace(learned=learned, pcount=pcount, ride_ok=pack_bool(pcount < 126))
    ts = td.state_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")
    js, ts = _run_both(jp, tp, jd.DeltaFaults(), td.DeltaFaults(), 3, js=js, ts=ts)
    pc = ts.pcount
    assert int(pc.max()) <= 126 and int(pc.min()) >= 0


def test_uniform_scatter_over_duplicate_targets():
    """At n = 5 the uniform exchange's targets collide on most ticks; the
    scatter-max (``scatter_reduce_`` "amax" with include_self on a zero
    plane) merges them as JAX's segment_max does."""
    jp, tp = _pair(5, 33, "uniform")
    for seed in range(4):
        jf, tf = _faults("drop", 5, seed)
        _run_both(jp, tp, jf, tf, 12, seed=seed)
    targets = torch.tensor([2, 2, 0, 2, 0])
    vals = torch.tensor([[0, 1], [1, 0], [0, 0], [0, 0], [1, 1]], dtype=torch.uint8)
    got = torch.zeros((5, 2), dtype=torch.uint8).scatter_reduce_(
        0, targets[:, None].expand(5, 2), vals, "amax", include_self=True)
    want = np.asarray(jax.ops.segment_max(jnp.asarray(vals.numpy()), jnp.asarray(targets.numpy()), num_segments=5))
    assert np.array_equal(got.numpy(), np.maximum(want, 0))


def test_survival_product_keeps_the_float32_order():
    """``((1-dn[a]) * (1-dn[b])) * (1-drop_rate)`` in float32: another
    association rounds differently on some lanes, and at u equal to the JAX
    product the port must give JAX's verdict on every one of them."""
    n = 200_000
    rng = np.random.default_rng(1)
    dn = rng.random(n).astype(np.float32) * np.float32(0.5)
    a = np.arange(n, dtype=np.int32)
    b = rng.permutation(n).astype(np.int32)
    rate = np.float32(0.0137)
    keep = ((np.float32(1) - dn[a]) * (np.float32(1) - dn[b])) * (np.float32(1) - rate)
    other = (np.float32(1) - dn[a]) * ((np.float32(1) - dn[b]) * (np.float32(1) - rate))
    assert (keep != other).sum() > 100  # the order matters on these lanes
    for u in (keep, np.nextafter(keep, np.float32(0)), other):
        jf = jd.DeltaFaults(drop_node=jnp.asarray(dn), drop_rate=jnp.float32(rate))
        want = np.asarray(jd.leg_survives(jf, jnp.asarray(u), jnp.asarray(a), jnp.asarray(b)))
        tf = td.faults_from_numpy(jf, device="cpu")
        got = td.leg_survives(tf, torch.from_numpy(u), torch.from_numpy(a).long(), torch.from_numpy(b).long())
        assert np.array_equal(got.numpy(), want)
    # the scalar-only leg compares u >= drop_rate in float32
    u = np.array([rate, np.nextafter(rate, np.float32(0)), np.float32(0.5)], np.float32)
    jf = jd.DeltaFaults(drop_rate=jnp.float32(rate))
    want = np.asarray(jd.leg_survives(jf, jnp.asarray(u), None, None))
    got = td.leg_survives(td.DeltaFaults(drop_rate=float(rate)), torch.from_numpy(u), None, None)
    assert np.array_equal(got.numpy(), want) and want.tolist() == [True, False, True]


def test_pair_connected_and_tier_pair_match_jax():
    n = 3000
    jf, tf = _faults("up group reach tier", n, seed=12)
    rng = np.random.default_rng(2)
    a = rng.integers(0, n, 5000).astype(np.int32)
    b = rng.integers(0, n, 5000).astype(np.int32)
    ta, tb = torch.from_numpy(a).long(), torch.from_numpy(b).long()
    assert np.array_equal(td.pair_connected(tf, ta, tb).numpy(),
                          np.asarray(jd.pair_connected(jf, jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(td.tier_pair(tf, ta, tb).numpy(), np.asarray(jd.tier_pair(jf, jnp.asarray(a), jnp.asarray(b))))
    assert np.array_equal(td.tier_pair_drop(tf, ta, tb).numpy(),
                          np.asarray(jd.tier_pair_drop(jf, jnp.asarray(a), jnp.asarray(b))))
    assert td.has_drop(tf) == jd.has_drop(jf)


def test_step_names_its_phases_for_the_profiler():
    """``step``'s profiler ranges are ``PHASES``, the names ``chip_smoke.py``
    reads its per-phase breakdown by."""
    from torch.profiler import ProfilerActivity, profile

    tp = td.DeltaParams(n=256, k=40, rng="counter")
    state = td.init_state(tp, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        td.step(tp, state)
    names = [e.key for e in prof.key_averages()]
    assert all(name in names for name in td.PHASES), names
    assert td.PHASES[:3] == ("ping-target", "rumor-exchange", "piggyback-counters")
