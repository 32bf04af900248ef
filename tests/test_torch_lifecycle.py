"""The lifecycle engine: PyTorch port against the JAX package.

Every leaf of the port's ``LifecycleState`` equals
``ringpop_tpu.sim.lifecycle``'s at every tick, at ``rng="counter"``, on the
CPU, bit for bit: both exchanges, K = 32, 40 and 64, crashes with
``up``, ``drop_rate``, ``drop_node``, ``group``/``reach`` partitions with
the healer firing, the topology tier legs, the ``suspect_ticks`` override
leg and a saturating ``max_p``; ``bench.py``'s BENCH_FAST configuration
(20,000 x 64, 5 victims) through detection; churn (crash, revive, eviction,
``admit`` of an evicted node); a run resumed from a JAX state; the
candidate select against every branch of the JAX package's hierarchical
``_top_m_sparse``.  Also the queries (``believed_key``/``believed_status``,
``detection_fraction`` on both paths, ``detection_complete``,
``view_checksums``, ``checksums_converged``), the run-until pair's tick
counts with the time-budget and zero-budget paths; at ``rng="threefry"``,
the default (``tests/test_torch_golden.py`` holds the small configurations
to the frozen goldens), both exchanges with drops, a partition with the
healer firing, ``heal_prob`` 0 and the default parameters through
``LifecycleSim``; the refusals, the slot
walk and first-live-learner plain versions against the JAX expressions
they replace, and the hazards the port meets (segment identities, dropped
scatter writes, the argmax of a bool, float32 division).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim.delta import DeltaFaults as JFaults
from ringpop_tpu.sim.packbits import block_count

from ringpop_tpu_torch.ops import lifecycle_kernel as lk
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.swim.member import FAULTY, SUSPECT

FIELDS = jl.LifecycleState._fields


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path here runs small tensors: more intra-op threads
    than one only contend with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# one compiled program per shape (an eager call retraces its slot loop)
_j_detection_complete = jax.jit(jl.detection_complete, static_argnums=(3,))


def assert_same_state(js, ts, where=""):
    tn = tl.state_to_numpy(ts)
    for name, a, b in zip(FIELDS, js, tn):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, name)


def _victims(n, count, seed=0):
    """bench.py's victim choice (bench.py:435-440)."""
    return np.sort(np.random.default_rng(seed).choice(n, size=count, replace=False))


def _faults(kind, n, down, seed):
    """(JAX DeltaFaults, port DeltaFaults) for a named fault mix with the
    nodes ``down`` crashed."""
    rng = np.random.default_rng(seed)
    legs = {}
    up = np.ones(n, bool)
    up[np.asarray(down, np.int64)] = False
    legs["up"] = up
    if "drop" in kind:
        legs["drop_rate"] = np.float32(0.05)
    if "node" in kind:
        legs["drop_node"] = (rng.random(n) * 0.2).astype(np.float32)
    if "group" in kind:
        legs["group"] = (np.arange(n) * 3 // n - (np.arange(n) % 97 == 0)).astype(np.int32)
    if "reach" in kind:
        reach = rng.random((3, 3)) < 0.5
        np.fill_diagonal(reach, True)
        legs["reach"] = reach
    if "tier" in kind:
        legs["tier_ids"] = np.stack([np.arange(n) // 16, np.arange(n) // 256,
                                     np.arange(n) // 1024]).astype(np.int32)
        legs["tier_drop"] = np.array([0.0, 0.02, 0.1, 0.3], np.float32)
    if "susp" in kind:
        legs["suspect_ticks"] = np.int32(3)
    if "default" in kind:
        legs["suspect_ticks"] = np.int32(-1)  # -1 = use the param
    jf = JFaults(**{k: jnp.asarray(v) for k, v in legs.items()})
    return jf, tl.faults_from_numpy(jf, device="cpu")


def _pair(n, k, exchange="shift", **kw):
    return (jl.LifecycleParams(n=n, k=k, exchange=exchange, rng="counter", **kw),
            tl.LifecycleParams(n=n, k=k, exchange=exchange, rng="counter", **kw))


def _jstep(jp):
    return jax.jit(lambda s, f: jl.step(jp, s, f))


def _run_both(jp, tp, jf, tf, ticks, seed=0, js=None, ts=None, every=None):
    """``ticks`` ticks of both engines from ``seed`` (or the given states),
    every leaf compared at every tick; ``every(t, js, ts)`` is called after
    each tick."""
    if js is None:
        js = jl.init_state(jp, seed=seed)
        ts = tl.init_state(tp, seed=seed, device="cpu")
        assert_same_state(js, ts, "init")
    jstep = _jstep(jp)
    for t in range(ticks):
        js = jstep(js, jf)
        ts = tl.step(tp, ts, tf)
        assert_same_state(js, ts, f"tick {t + 1}")
        if every is not None:
            every(t + 1, js, ts)
    return js, ts


def _assert_same_queries(js, ts, jf, tf, subjects, where=""):
    """Every query of the port equals the JAX package's on one state."""
    subj = np.asarray(subjects, np.int64)
    bk_j, bk_t = np.asarray(jl.believed_key(js, subj)), tl.believed_key(ts, subj)
    assert bk_t.dtype == torch.int32 and np.array_equal(bk_j, bk_t.numpy()), where
    bs_j, bs_t = np.asarray(jl.believed_status(js, subj)), tl.believed_status(ts, subj)
    assert bs_t.dtype == torch.int8 and np.array_equal(bs_j, bs_t.numpy()), where
    for min_status in (SUSPECT, FAULTY):
        fj = np.asarray(jl.detection_fraction(js, subj, jf, min_status))
        ft = tl.detection_fraction(ts, subj, tf, min_status)
        assert ft.dtype == torch.float32 and fj.dtype == np.float32
        assert np.array_equal(fj, ft.numpy()), (where, "fraction", min_status)
        # the large-scale path, called directly (its switch is at 2**28)
        lj = np.asarray(jl._detection_fraction_large(js, subj, jf, min_status))
        lt = tl._detection_fraction_large(ts, subj, tf, min_status)
        assert lt.dtype == torch.float32 and np.array_equal(lj, lt.numpy()), (where, "large", min_status)
        assert bool(_j_detection_complete(js, jnp.asarray(subj, jnp.int32), jf, min_status)) == bool(
            tl.detection_complete(ts, subj, tf, min_status)), (where, "complete", min_status)
    cj = np.asarray(jl.view_checksums(js, jf))
    ct = tl.view_checksums(ts, tf)
    assert ct.dtype == torch.int64 and np.array_equal(cj.astype(np.int64), ct.numpy()), where
    assert bool(jl.checksums_converged(js, jf)) == bool(tl.checksums_converged(ts, tf)), where


# -- every leaf, every tick ----------------------------------------------------

CONFIGS = [
    # (n, k, exchange, faults, victims, ticks, params)
    (4096, 32, "shift", "", 12, 36, {}),
    (2048, 40, "uniform", "", 12, 32, {}),
    (2048, 40, "shift", "drop", 20, 30, {"suspect_ticks": 5}),
    (2048, 64, "uniform", "drop node", 20, 24, {"suspect_ticks": 5}),
    (2048, 40, "shift", "group", 8, 30, {"heal_prob": 0.6, "suspect_ticks": 4}),
    (2048, 32, "uniform", "group reach", 8, 24, {"heal_prob": 0.6, "suspect_ticks": 4}),
    (2048, 64, "shift", "tier node", 16, 24, {"suspect_ticks": 4}),
    (2048, 40, "uniform", "tier drop", 16, 24, {}),
    (2048, 32, "shift", "susp", 16, 24, {}),
    (2048, 32, "shift", "default drop", 16, 30, {"suspect_ticks": 4, "faulty_ticks": 6,
                                                 "tombstone_ticks": 5}),
    (2048, 40, "shift", "drop", 40, 32, {"max_p": 2, "suspect_ticks": 3, "alloc_per_tick": 16}),
    (2048, 64, "uniform", "", 30, 24, {"max_p": 0, "suspect_ticks": 3}),
]


@pytest.mark.parametrize("n,k,exchange,kind,n_down,ticks,kw", CONFIGS)
def test_every_leaf_every_tick_matches_jax(n, k, exchange, kind, n_down, ticks, kw):
    jp, tp = _pair(n, k, exchange, **kw)
    down = _victims(n, n_down, seed=n + k)
    jf, tf = _faults(kind, n, down, seed=k)
    js, ts = _run_both(jp, tp, jf, tf, ticks, seed=k)
    if "drop" in kind:  # the queries read only ``up`` of the fault legs
        _assert_same_queries(js, ts, jf, tf, down[:6], f"{kind} final")


THREEFRY_CONFIGS = [
    # (n, k, exchange, faults, victims, ticks, params)
    (2048, 40, "shift", "drop", 20, 30, {"suspect_ticks": 5}),
    (2048, 64, "uniform", "drop node", 20, 24, {"suspect_ticks": 5}),
    (2048, 40, "shift", "group", 8, 30, {"heal_prob": 0.6, "suspect_ticks": 4}),
    (2048, 32, "shift", "drop", 16, 24, {"heal_prob": 0.0, "suspect_ticks": 3}),
]


@pytest.mark.parametrize("n,k,exchange,kind,n_down,ticks,kw", THREEFRY_CONFIGS)
def test_threefry_every_leaf_every_tick_matches_jax(n, k, exchange, kind, n_down, ticks, kw):
    """The JAX default stream: the five-way split, the shift or targets,
    the drop coin, the healer's split and draws (skipped at ``heal_prob``
    0) and the peers' split, [N, 3] randint and ping-req coins."""
    jp = jl.LifecycleParams(n=n, k=k, exchange=exchange, **kw)
    tp = tl.LifecycleParams(n=n, k=k, exchange=exchange, **kw)
    assert jp.rng == tp.rng == "threefry"
    down = _victims(n, n_down, seed=n + k)
    jf, tf = _faults(kind, n, down, seed=k)
    js, ts = _run_both(jp, tp, jf, tf, ticks, seed=k)
    _assert_same_queries(js, ts, jf, tf, down[:6], f"{kind} final")


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


# -- the candidate select --------------------------------------------------------


def test_candidate_select_matches_every_sparse_topk_branch(monkeypatch):
    """The port's full stable sort against each runtime branch of the JAX
    package's ``_top_m_sparse``, forced at 512 nodes by monkeypatching its
    caps (as tests/test_lifecycle.py does): the dense top_k, the
    hierarchical select, the hierarchical select with cap < m padding, and
    the overflow fallback.  The packed layout declares 30 equal-key
    suspicions at once: more tied candidates than alloc_per_tick = 8."""
    n, k = 512, 16
    spread = list(range(3, 503, 10))
    packed = list(range(30)) + [100, 300]
    jp, tp = _pair(n, k, alloc_per_tick=8, suspect_ticks=4)
    saw = set()
    orig = jl._top_m_sparse

    def recording(cand, m):
        cap = jl._SPARSE_TOPK_CAP
        if n > max(cap, jl._SPARSE_TOPK_MIN_N) and m <= cap:
            b = block_count(n, jl._TOPK_BLOCKS)
            cap_eff = min(cap, n // b)

            def note(counts):
                counts = np.asarray(counts)
                if (counts > cap_eff).any():
                    saw.add("overflow")
                elif counts.sum():
                    saw.add("hierarchical-padded" if cap_eff < m else "hierarchical")

            jax.debug.callback(note, (cand.reshape(b, n // b) >= 0).sum(axis=1))
        return orig(cand, m)

    monkeypatch.setattr(jl, "_top_m_sparse", recording)

    def run(cap, min_n, blocks, victims):
        monkeypatch.setattr(jl, "_SPARSE_TOPK_CAP", cap)
        monkeypatch.setattr(jl, "_SPARSE_TOPK_MIN_N", min_n)
        monkeypatch.setattr(jl, "_TOPK_BLOCKS", blocks)
        jf, tf = _faults("", n, victims, seed=0)
        _run_both(jp, tp, jf, tf, 16, seed=3)
        jax.effects_barrier()

    run(4096, 1 << 30, 16, packed)  # the dense top_k
    run(32, 0, 16, spread)
    assert "hierarchical" in saw
    run(32, 0, 128, spread)  # blocks of 4 subjects: cap min(32, 4) < m = 8
    assert "hierarchical-padded" in saw
    run(8, 0, 16, packed)
    assert "overflow" in saw


def test_top_m_is_lax_top_k_with_its_tie_order():
    rng = np.random.default_rng(1)
    for n, m in ((512, 8), (100, 100), (33, 1), (4096, 64)):
        for vals in (rng.integers(-1, 3, n), np.full(n, -1), rng.integers(-1, 2**31 - 1, n)):
            vals = vals.astype(np.int32)
            jv, ji = jax.lax.top_k(jnp.asarray(vals), m)
            tv, ti = tl._top_m(torch.from_numpy(vals), m)
            assert np.array_equal(np.asarray(jv), tv.numpy()) and np.array_equal(np.asarray(ji), ti.numpy())


# -- the run loops ------------------------------------------------------------


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


# -- the kernels' plain versions against the JAX expressions they replace -----


def _random_state(n, k, seed, multi=True):
    """A JAX LifecycleState with a random rumor table (free slots, subjects
    holding many slots, keys of every status, equal keys) and a random
    learned plane; the port's copy of it."""
    rng = np.random.default_rng(seed)
    p = jl.LifecycleParams(n=n, k=k, rng="counter")
    js = jl.init_state(p, seed=seed)
    subj = rng.integers(0, n, k).astype(np.int32)
    if multi:
        subj[: k // 3] = subj[0]  # one subject holds a third of the slots
    subj[rng.random(k) < 0.25] = -1
    inc = rng.integers(0, 4, k).astype(np.int32)
    status = rng.integers(0, 5, k).astype(np.int8)
    learned = rng.integers(0, 2**32, (n, (k + 31) // 32), dtype=np.uint64).astype(np.uint32)
    learned &= np.asarray(jl.pack_bool(jnp.ones(k, bool)))[None, :]  # tail bits zero
    learned[rng.random(n) < 0.3] = 0
    base_present = rng.random(n) < 0.9
    js = js._replace(
        r_subject=jnp.asarray(subj), r_inc=jnp.asarray(inc), r_status=jnp.asarray(status),
        learned=jnp.asarray(learned), base_present=jnp.asarray(base_present),
        base_status=jnp.asarray(rng.integers(0, 5, n).astype(np.int8)),
        base_inc=jnp.asarray(rng.integers(0, 3, n).astype(np.int32)))
    return js, tl.state_from_numpy(jax.tree_util.tree_map(np.asarray, js), device="cpu")


@pytest.mark.parametrize("n,k", [(1, 40), (31, 64), (33, 40), (600, 64), (257, 256)])
def test_slot_walk_plain_matches_the_jax_walk(n, k):
    for seed in range(2):
        js, ts = _random_state(n, k, seed, multi=seed == 0)
        rkey = tl._rkey(ts)
        jkey = jnp.where(js.r_subject >= 0, jl._key_of(js.r_inc, js.r_status), -1)
        sentinel = jnp.where(js.r_subject >= 0, js.r_subject, n)
        jorder = np.asarray(jnp.lexsort((-jkey, sentinel)))
        order, sorted_subj, sorted_key = lk.walk_order(ts.r_subject, rkey, n)
        assert np.array_equal(order.numpy(), jorder)
        assert np.array_equal(sorted_subj.numpy(), np.asarray(sentinel)[jorder])
        base_key = tl._base_key(ts)
        # the checksum mode is view_checksums without the uncovered-subject term
        cj = np.asarray(jl.view_checksums(js)).astype(np.int64)
        covered = tl._slot_covered(ts)
        uncovered = torch.where(~covered, lk.member_term(torch.arange(n), base_key), 0).sum()
        got = lk.slot_walk(ts.learned, order, sorted_subj, sorted_key, base_key, "checksum")
        assert np.array_equal(((got + uncovered) & 0xFFFFFFFF).numpy(), cj)
        assert np.array_equal(tl.view_checksums(ts).numpy(), cj)
        obs = torch.from_numpy(np.random.default_rng(seed).random(n) < 0.8)
        for min_status in (SUSPECT, FAULTY):
            def finalize(anybad, s, m, fin):
                bad_any = (jnp.asarray(obs.numpy()) & (m >= 0)
                           & (jl._status_of(jnp.maximum(m, 0)) < min_status)).any()
                return anybad.at[jnp.where(fin, s, n)].set(jnp.where(fin, bad_any, False), mode="drop")

            want = np.asarray(jl._walk_subject_slots(js, jnp.asarray(base_key.numpy()),
                                                     jnp.zeros(n, bool), finalize))
            got = lk.slot_walk(ts.learned, order, sorted_subj, sorted_key, base_key, "detect", obs, min_status)
            assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), min_status


@pytest.mark.parametrize("n,k", [(1, 40), (31, 64), (33, 40), (4097, 64), (300, 256)])
def test_first_live_learner_plain_matches_jax_argmax(n, k):
    rng = np.random.default_rng(n + k)
    for density in (0.0, 0.002, 0.5):
        bits = rng.random((n, k)) < density
        bits[:, :3] = False  # columns with no learner at all
        for up in (None, rng.random(n) < 0.7, np.zeros(n, bool)):
            lb = jnp.asarray(bits) & (True if up is None else jnp.asarray(up)[:, None])
            want = np.asarray(jnp.argmax(lb, axis=0).astype(jnp.int32))
            plane = torch.from_numpy(np.array(jl.pack_bool(jnp.asarray(bits))).view(np.int32))
            got = lk.first_live_learner(plane, None if up is None else torch.from_numpy(up), k)
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), (density, up is None)


# -- hazards -----------------------------------------------------------------


def test_segment_identities_and_dropped_scatters():
    """``segment_max``/``segment_min`` with ``num_segments = n + 1``: an
    empty segment holds int32 min (max) and int32 max (min, which is
    NO_DEADLINE); segment n is the dump.  A scatter at index n is dropped."""
    n = 10
    rng = np.random.default_rng(3)
    vals = rng.integers(-5, 100, 16).astype(np.int32)
    seg = rng.integers(0, n + 1, 16).astype(np.int32)
    seg[seg == 4] = n  # segment 4 stays empty
    for jfn, tfn in ((jax.ops.segment_max, tl._segment_max), (jax.ops.segment_min, tl._segment_min)):
        want = np.asarray(jfn(jnp.asarray(vals), jnp.asarray(seg), num_segments=n + 1))[:n]
        got = tfn(torch.from_numpy(vals), torch.from_numpy(seg), n)
        assert np.array_equal(got.numpy(), want)
    assert int(tl._segment_min(torch.from_numpy(vals), torch.from_numpy(seg), n)[4]) == tl.NO_DEADLINE
    on = rng.random(16) < 0.5
    want = np.asarray(jnp.zeros(n, bool).at[jnp.asarray(seg)].max(jnp.asarray(on), mode="drop"))
    assert np.array_equal(tl._scatter_any(n, torch.from_numpy(seg), torch.from_numpy(on)).numpy(), want)


def test_first_true_of_a_bool_mask():
    """``jnp.argmax(up)`` is the first True; torch's CPU argmax refuses a
    bool tensor, so the port casts first."""
    for up in ([True, True], [False, True, True], [False] * 5, [False, False, False, True]):
        t = torch.tensor(up)
        with pytest.raises(RuntimeError):
            t.argmax()
        assert int(t.to(torch.int32).argmax()) == int(jnp.argmax(jnp.asarray(up)))


def test_pcount_saturates_and_wraps_like_int8():
    """The int8 counter sum at the cap: both packages add in int8."""
    a = np.array([125, 126, 127, -128, 0], np.int8)
    b = np.array([1, 1, 1, 1, 2], np.int8)
    want = np.asarray(jnp.minimum(jnp.asarray(a) + jnp.asarray(b), jnp.int8(126)))
    got = (torch.from_numpy(a) + torch.from_numpy(b)).clamp_max(126)
    assert np.array_equal(got.numpy(), want)


def test_detection_fraction_is_float32_division():
    """JAX divides int32 by int32 in float32 (x64 off); the large path
    divides in float64 and rounds once to float32."""
    js, ts = _random_state(3001, 64, seed=9)
    subj = [0, 5, 17, int(np.asarray(js.r_subject)[0])]
    up = np.random.default_rng(9).random(3001) < 0.97
    jf, tf = JFaults(up=jnp.asarray(up)), tl.faults_from_numpy(JFaults(up=jnp.asarray(up)), device="cpu")
    for fn in ("detection_fraction", "_detection_fraction_large"):
        want = np.asarray(getattr(jl, fn)(js, subj, jf))
        got = getattr(tl, fn)(ts, subj, tf)
        assert want.dtype == np.float32 and got.dtype == torch.float32
        assert np.array_equal(want, got.numpy()), fn


# -- refusals -----------------------------------------------------------------


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
    with pytest.raises(NotImplementedError, match="A12"):
        tl.step(tl.LifecycleParams(n=64, k=32, rng="counter", exchange_mesh=object()), state)
    with pytest.raises(NotImplementedError, match="A7"):
        tl.step(counter, state, telemetry=object())
    with pytest.raises(NotImplementedError, match="A7"):
        tl.LifecycleSim(64, k=32, rng="counter", telemetry=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A15"):
        tl.LifecycleSim(64, k=32, rng="counter", aot="tag", device="cpu")
    sim = tl.LifecycleSim(64, k=32, rng="counter", device="cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        sim.run_until_detected([1], learned_sharding=object())
    with pytest.raises(NotImplementedError, match="A12"):
        tl.detection_complete(state, [1], learned_sharding=object())
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
