"""The lifecycle kernels' plain versions against the JAX expressions they
replace, on the rumor tables and planes the kernels' designs split on.

L1 (``ops.lifecycle_kernel.slot_walk``) splits the sorted slot walk by the
runs of the sorted order: subjects that hold one slot (the headline's
shape) go through per-word masks and nibble tables, subjects that hold
several through a short list walked with the first-learned rule.  So its
plain version is held here, bit for bit, against the JAX package's
``_walk_subject_slots`` — directly in both modes, and through
``detection_complete`` and ``view_checksums`` on states carried across with
``state_from_numpy`` — on tables where every subject holds one slot, where
subjects hold the two or three slots around a word boundary, where one
subject holds a third of the slots, full and free tables, with tombstone
and absent base keys, at K = 40 (tail bits), 64 and 256.  L2
(``first_live_learner``) takes the tick's ``fire_s | fire_f`` as ``want``:
wanted slots equal ``jnp.argmax(unpack_bits(learned, k) & up[:, None], 0)``
and the others are 0, for ``want`` empty, all, random and a slot whose only
live learner is the last row.  The route each shape takes and the
launchers' refusals are checked too; the kernels themselves run in
``chip_smoke.py`` phase 8 on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim.delta import DeltaFaults as JFaults

from ringpop_tpu_torch.ops import lifecycle_kernel as lk
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.swim.member import FAULTY, SUSPECT, TOMBSTONE

KINDS = ("single", "straddle", "third", "full", "free")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: more intra-op threads only contend with the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _table(rng, n, k, kind):
    """int32[K] subjects (-1 = free) of a rumor table of ``kind``."""
    if kind == "single":  # every subject one slot
        subj = rng.permutation(n)[:k].astype(np.int32)
    else:
        subj = rng.integers(0, n, k).astype(np.int32)
    if kind == "straddle":  # 31|32 share a subject, 63|64|65 another, ...
        for edge in range(32, k, 32):
            span = 2 + (edge // 32) % 2
            subj[edge - 1: edge - 1 + span] = subj[edge - 1]
    if kind == "third":
        subj[: k // 3] = subj[0]
    if kind not in ("full", "straddle"):
        subj[rng.random(k) < (1.0 if kind == "free" else 0.25)] = -1
    return subj


def _state(n, k, kind, seed, density=0.4):
    """A JAX LifecycleState with a ``kind`` rumor table, keys of every
    status (tombstones and equal keys included), a random plane with empty
    rows, tombstone and absent base keys; and the port's copy of it."""
    rng = np.random.default_rng(seed)
    js = jl.init_state(jl.LifecycleParams(n=n, k=k, rng="counter"), seed=seed)
    subj = _table(rng, n, k, kind)
    bits = rng.random((n, k)) < density
    bits[rng.random(n) < 0.2] = False
    base_status = rng.integers(0, 5, n).astype(np.int8)
    base_status[rng.random(n) < 0.2] = TOMBSTONE
    js = js._replace(
        r_subject=jnp.asarray(subj), r_inc=jnp.asarray(rng.integers(0, 4, k).astype(np.int32)),
        r_status=jnp.asarray(rng.integers(0, 5, k).astype(np.int8)),
        learned=jl.pack_bool(jnp.asarray(bits)), base_present=jnp.asarray(rng.random(n) < 0.8),
        base_status=jnp.asarray(base_status), base_inc=jnp.asarray(rng.integers(0, 3, n).astype(np.int32)))
    return js, tl.state_from_numpy([np.asarray(v) for v in js], device="cpu")


def _jax_walk(js, base_key, mode, obs=None, min_status=0):
    """The JAX package's slot walk with the finalize of ``view_checksums``
    (checksum mode, without the uncovered subjects' term) or of
    ``detection_complete`` (detect mode)."""
    n = js.learned.shape[0]
    if mode == "checksum":
        def finalize(acc, s, m, fin):
            include = (m >= 0) & (jl._status_of(jnp.maximum(m, 0)) != TOMBSTONE)
            h = jl._mix32(jl._mix32(s.astype(jnp.uint32)) ^ m.astype(jnp.uint32))
            return acc + jnp.where(fin & include, h, jnp.uint32(0))

        carry = jnp.zeros(n, jnp.uint32)
    else:
        jobs = jnp.asarray(obs)

        def finalize(anybad, s, m, fin):
            bad_any = (jobs & (m >= 0) & (jl._status_of(jnp.maximum(m, 0)) < min_status)).any()
            return anybad.at[jnp.where(fin, s, n)].set(jnp.where(fin, bad_any, False), mode="drop")

        carry = jnp.zeros(n, bool)
    return np.asarray(jl._walk_subject_slots(js, jnp.asarray(base_key.numpy()), carry, finalize))


@pytest.mark.parametrize("k", [40, 64, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_slot_walk_plain_matches_the_jax_walk_on_each_table_shape(kind, k):
    n = 300
    js, ts = _state(n, k, kind, seed=k + len(kind))
    order, ss, sk = lk.walk_order(ts.r_subject, tl._rkey(ts), n)
    base_key = tl._base_key(ts)
    got = lk.slot_walk(ts.learned, order, ss, sk, base_key, "checksum")
    want = _jax_walk(js, base_key, "checksum").astype(np.int64)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    obs = np.random.default_rng(k).random(n) < 0.85
    for min_status in (SUSPECT, FAULTY):
        got = lk.slot_walk(ts.learned, order, ss, sk, base_key, "detect", torch.from_numpy(obs), min_status)
        want = _jax_walk(js, base_key, "detect", obs, min_status)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), min_status


@pytest.mark.parametrize("k", [40, 64, 256])
@pytest.mark.parametrize("kind", KINDS)
def test_queries_through_the_walk_match_jax(kind, k):
    """``view_checksums`` and ``detection_complete`` on a state carried
    across, for the table's own subjects and for subjects with no slot."""
    n = 300
    js, ts = _state(n, k, kind, seed=2 * k + len(kind), density=0.9)
    assert np.array_equal(tl.view_checksums(ts).numpy(), np.asarray(jl.view_checksums(js)).astype(np.int64))
    up = np.random.default_rng(k).random(n) < 0.9
    jf, tf = JFaults(up=jnp.asarray(up)), tl.faults_from_numpy(JFaults(up=up), device="cpu")
    subj = np.asarray(js.r_subject)
    for subjects in (np.unique(subj[subj >= 0])[:6], np.array([0, 7, 299])):
        if subjects.size == 0:
            continue
        for min_status in (SUSPECT, FAULTY):
            want = bool(jl.detection_complete(js, jnp.asarray(subjects), jf, min_status))
            got = tl.detection_complete(ts, subjects, tf, min_status)
            assert bool(got) == want, (subjects, min_status)


def test_single_slot_subjects_take_term_or_base_by_their_bit():
    """The design's premise for single-slot subjects: a node's term is the
    slot's (key above the base) where it learned the slot, the base's where
    it did not — so the checksum is C + the sum over set bits of
    (term - base), which the nibble tables compute."""
    n, k = 64, 40
    js, ts = _state(n, k, "single", seed=5)
    order, ss, sk = lk.walk_order(ts.r_subject, tl._rkey(ts), n)
    base_key = tl._base_key(ts)
    got = lk.slot_walk(ts.learned, order, ss, sk, base_key, "checksum")
    bits = tl.unpack_bits(ts.learned, k)
    acc = torch.zeros(n, dtype=torch.int64)
    for slot in range(k):
        s = int(ts.r_subject[slot])
        if s < 0:
            continue
        bkey = base_key[s]
        term = lk.member_term(s, torch.maximum(tl._rkey(ts)[slot], bkey))
        acc += torch.where(bits[:, slot], term, lk.member_term(s, bkey))
    assert torch.equal(got, acc & 0xFFFFFFFF)


def _lb(bits, up):
    return jnp.asarray(bits) & (True if up is None else jnp.asarray(up)[:, None])


@pytest.mark.parametrize("n,k", [(1, 40), (33, 64), (300, 256), (4097, 64)])
def test_first_live_learner_plain_with_want_matches_jax_argmax(n, k):
    rng = np.random.default_rng(n * k)
    bits = rng.random((n, k)) < 0.05
    bits[:, :3] = False  # columns with no learner at all
    plane = torch.from_numpy(np.array(jl.pack_bool(jnp.asarray(bits))).view(np.int32))
    for up in (None, rng.random(n) < 0.7):
        argmax = np.asarray(jnp.argmax(_lb(bits, up), axis=0).astype(jnp.int32))
        tup = None if up is None else torch.from_numpy(up)
        for want in (np.zeros(k, bool), np.ones(k, bool), rng.random(k) < 0.3):
            got = lk.first_live_learner(plane, tup, k, torch.from_numpy(want))
            assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.where(want, argmax, 0))
        assert np.array_equal(lk.first_live_learner(plane, tup, k).numpy(), argmax)


@pytest.mark.parametrize("n,k", [(2, 40), (257, 64), (1000, 256)])
def test_first_live_learner_finds_a_lone_last_row_learner(n, k):
    """A wanted slot whose only live learner is the last row (the case
    where the kernel reads every row), beside slots learned early and a
    learner in a down row above it."""
    rng = np.random.default_rng(k)
    bits = rng.random((n, k)) < 0.3
    lone = [3, k // 2, k - 1]
    bits[:, lone] = False
    bits[n - 1, lone] = True
    bits[0, k // 2] = True
    up = np.ones(n, bool)
    up[0] = False
    plane = torch.from_numpy(np.array(jl.pack_bool(jnp.asarray(bits))).view(np.int32))
    want = np.zeros(k, bool)
    want[lone + [5]] = True
    argmax = np.asarray(jnp.argmax(_lb(bits, up), axis=0).astype(jnp.int32))
    got = lk.first_live_learner(plane, torch.from_numpy(up), k, torch.from_numpy(want))
    assert np.array_equal(got.numpy(), np.where(want, argmax, 0))
    assert (got.numpy()[lone] == n - 1).all()


def test_walk_launcher_refuses_a_width_past_shared_memory(monkeypatch):
    """L1 keeps per-word tables in shared memory: a plane wider than
    ``MAX_WORDS`` is refused, in both modes, before anything is built."""
    monkeypatch.setattr(lk, "_require_cuda", lambda t, what: None)
    monkeypatch.setattr(lk, "_library", lambda: pytest.fail("built a kernel for a refused call"))
    n, w = 4, lk.MAX_WORDS + 1
    k = 32 * w
    meta = dict(device="meta")
    wide = torch.empty((n, w), dtype=torch.int32, **meta)
    slots = [torch.empty(k, dtype=torch.int64, **meta)] + [torch.empty(k, dtype=torch.int32, **meta)] * 2
    base_key = torch.empty(n, dtype=torch.int32, **meta)
    obs = torch.empty(n, dtype=torch.bool, **meta)
    for mode in ("checksum", "detect"):
        with pytest.raises(ValueError, match="wider than the lifecycle kernels take"):
            lk.slot_walk_cuda(wide, *slots, base_key, mode, obs, 3)


def test_width_limit_is_one_number_for_both_kernels(monkeypatch):
    """``check_width`` takes ``MAX_WORDS`` words (K = 7008) and refuses one
    more; ``init_state`` on the card refuses such a K before it allocates."""
    assert lk.MAX_WORDS == 219
    lk.check_width(lk.MAX_WORDS, "test")
    with pytest.raises(ValueError, match="219 words, K <= 7008"):
        lk.check_width(lk.MAX_WORDS + 1, "test")
    monkeypatch.setattr(tl, "resolve_device", lambda device: torch.device("cuda"))
    with pytest.raises(ValueError, match="init_state"):
        tl.init_state(tl.LifecycleParams(n=64, k=32 * lk.MAX_WORDS + 1, rng="counter"))


def test_state_from_numpy_holds_the_load_to_the_width_limit(monkeypatch):
    """Loading a state onto the card takes the same ``MAX_WORDS`` limit as
    ``init_state``: a plane one word wider is refused at load, before any
    leaf is uploaded, not at its first tick.  The CPU takes any width."""
    def leaves(w):
        shapes = {"learned": (4, w), "ride_ok": (4, w), "pcount": (4, 32 * w), "tick": (), "key": (2,)}
        return [np.zeros(shapes.get(name, (4,) if name.startswith(("base_", "self_")) else (32 * w,)),
                         tl._LEAF_DTYPES[name][0]) for name in tl.LifecycleState._fields]

    wide = leaves(lk.MAX_WORDS + 1)
    assert tl.state_from_numpy(wide, device="cpu").learned.shape == (4, lk.MAX_WORDS + 1)
    monkeypatch.setattr(tl, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch, "as_tensor", lambda *a, **k: pytest.fail("uploaded a leaf of a refused state"))
    with pytest.raises(ValueError, match="state_from_numpy: a plane of 220 words is wider"):
        tl.state_from_numpy(wide)
    with pytest.raises(pytest.fail.Exception, match="uploaded a leaf"):
        tl.state_from_numpy(leaves(lk.MAX_WORDS))  # the widest plane passes the check


def test_learner_launcher_refuses_a_bad_want(monkeypatch):
    """``want`` is the tick's bool[K] mask on the plane's device: anything
    else is refused before any kernel is built.  A meta tensor stands in
    for a CUDA one."""
    monkeypatch.setattr(lk, "_require_cuda", lambda t, what: None)
    monkeypatch.setattr(lk, "_library", lambda: pytest.fail("built a kernel for a refused call"))
    p = torch.empty((4, 2), dtype=torch.int32, device="meta")
    for want in (torch.ones(40, dtype=torch.int32, device="meta"), torch.ones(39, dtype=torch.bool, device="meta"),
                 torch.ones(40, dtype=torch.bool)):
        with pytest.raises(ValueError, match="want"):
            lk.first_live_learner_cuda(p, None, 40, want)


def test_learner_launcher_refuses_a_width_past_shared_memory(monkeypatch):
    """L2 keeps a first-row table per warp in shared memory (~1 KB a plane
    word): past ``MAX_WORDS`` it refuses the plane before building anything."""
    monkeypatch.setattr(lk, "_require_cuda", lambda t, what: None)
    monkeypatch.setattr(lk, "_library", lambda: pytest.fail("built a kernel for a refused call"))
    wide = torch.empty((4, lk.MAX_WORDS + 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="wider than the lifecycle kernels take"):
        lk.first_live_learner_cuda(wide, None, 32 * (lk.MAX_WORDS + 1))


def test_reset_launches_clears_the_counts():
    lk.launches["slot_walk"] = 4
    lk.launches["first_live_learner"] = 2
    lk.reset_launches()
    assert lk.launches == {"slot_walk": 0, "first_live_learner": 0}
