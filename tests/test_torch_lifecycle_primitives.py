"""The lifecycle engine's primitives: PyTorch port against the JAX package.

The candidate select against every branch of the JAX package's
hierarchical ``_top_m_sparse`` and ``lax.top_k``'s tie order; the slot
walk and first-live-learner plain versions against the JAX expressions they
replace; and the hazards the port meets (segment identities, dropped
scatter writes, the argmax of a bool, int8 saturation, float32 division).
Apart from ``tests/test_torch_lifecycle.py`` (every leaf at every tick) so
that the test scheduler can run the two on different workers.  The
tolerance is none.
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
from test_torch_lifecycle import _faults, _pair, _run_both


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
