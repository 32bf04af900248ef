"""The port's DGRO placement pass against the JAX package's, bit for bit.

``dgro_place`` at small server sets — the chosen tokens and owners and every
report field — with probe counts that are not powers of two (the scorer's
float32 means and ratios differ in the last bit between a division and
XLA's reciprocal product there); the raw float32 scores of the batched
scorer on rings with a token at 0 and at 0xFFFFFFFF (the uint32 wrap arc)
and with a live token tied with the churn probe's dead ones; the sticky
replay; ``key_movement``; and ``RingStore(placement="dgro")``'s update,
drain and rescore records and serve lookups.  The tolerance is none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ringpop_tpu.serve import placement as jp
from ringpop_tpu.serve import state as jst

from ringpop_tpu_torch.serve import placement as tp
from ringpop_tpu_torch.serve import state as tst


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _servers(n, prefix=8):
    return [f"10.{prefix}.{i // 256}.{i % 256}:3000" for i in range(n)]


# (servers, points, candidates, probes, churn_frac, seed); every probe
# count but the last is not a power of two
CONFIGS = [
    (8, 20, 4, 1000, 0.25, 0),
    (12, 30, 5, 999, 0.2, 1),
    (16, 50, 6, 3001, 0.1, 2),
    (10, 33, 4, 777, 0.3, 3),
    (16, 40, 6, 1 << 12, 0.0625, 4),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=[f"s{c[0]}-p{c[3]}" for c in CONFIGS])
def test_dgro_place_matches_jax(cfg):
    s, points, cand, probes, churn, seed = cfg
    kw = dict(candidates=cand, probes=probes, churn_frac=churn, seed=seed)
    jt, jo, jrep = jp.dgro_place(_servers(s), points, **kw)
    tt, to, trep = tp.dgro_place(_servers(s), points, device="cpu", **kw)
    assert tt.dtype == np.uint32 and to.dtype == np.int32
    assert np.array_equal(tt, jt) and np.array_equal(to, jo)
    assert trep == jrep
    assert trep["family"] > cand  # the local-move candidates were scored too


def _raw_scores(flats, owners, probes, cohort):
    j = jp._score_candidates(jnp.asarray(flats.astype(np.uint32)), jnp.asarray(owners),
                             jnp.asarray(probes), jnp.asarray(cohort))
    t = tp._score_candidates(torch.from_numpy(flats.astype(np.int64)), torch.from_numpy(owners.astype(np.int64)),
                             torch.from_numpy(probes.astype(np.int64)), torch.from_numpy(cohort))
    return [np.asarray(a) for a in j], [a.numpy() for a in t]


def _assert_bits_equal(want, got):
    for w, g in zip(want, got):
        assert g.dtype == np.float32
        assert np.array_equal(w.view(np.uint32), g.view(np.uint32)), (w, g)


@pytest.mark.parametrize("n_probes", [999, 1000, 3001, 12345])
def test_scorer_float32_bits_match_jax(n_probes):
    """The four score vectors, compared as bit patterns, over candidates of
    the family at probe counts where a division and a reciprocal product
    differ."""
    servers = _servers(12, 1)
    base = jnp.asarray(jp.ring_tokens(servers, 30).reshape(-1).astype(np.uint32))
    flats = np.stack([np.asarray(jp._flat_tokens(base, int(v)))
                      for v in (np.arange(4, dtype=np.uint64) * jp._SALT_STRIDE).astype(np.uint32)])
    owners = np.repeat(np.arange(12, dtype=np.int32), 30)
    rng = np.random.default_rng(n_probes)
    probes = rng.integers(0, 2**32, size=n_probes, dtype=np.uint32)
    cohort = np.zeros(12, bool)
    cohort[[1, 5, 7]] = True
    want, got = _raw_scores(flats, owners, probes, cohort)
    _assert_bits_equal(want, got)


def test_scorer_wrap_arc_and_dead_token_ties():
    """Rings with a token at 0 (the wrap arc is uint32 arithmetic) and at
    0xFFFFFFFF, a live token tied with the churn probe's dead tokens, and
    a single-token ring."""
    owners = np.array([0, 0, 1, 1, 2, 2], np.int32)
    flats = np.array([
        [0, 0x4000_0000, 0x8000_0000, 0x9000_0000, 0xC000_0000, 0xFFFF_FFFF],
        [0xFFFF_FFFF, 7, 0x1234_5678, 0xFFFF_FFFF, 0xFFFF_FFFE, 0],
        [5, 5, 5, 0xFFFF_FFFF, 0xFFFF_FFFF, 0xFFFF_FFFF],
        [0, 1, 2, 3, 4, 5],
    ], np.int64)
    rng = np.random.default_rng(7)
    probes = np.concatenate([rng.integers(0, 2**32, size=997, dtype=np.uint32),
                             np.array([0, 1, 5, 0xFFFF_FFFE, 0xFFFF_FFFF], np.uint32)])
    for dead in ([0], [1], [2], [0, 2]):
        cohort = np.zeros(3, bool)
        cohort[dead] = True
        want, got = _raw_scores(flats, owners, probes, cohort)
        _assert_bits_equal(want, got)
    want, got = _raw_scores(np.array([[0x8000_0000]], np.int64), np.array([0], np.int32), probes[:10],
                            np.zeros(1, bool))
    _assert_bits_equal(want, got)


def test_sticky_replay_equals_the_scored_pick_and_jax():
    servers = _servers(12, 3)
    kw = dict(candidates=4, probes=999, churn_frac=0.2, seed=5, local_moves=(1, 2, 4, 8))
    jt, jo, jrep = jp.dgro_place(servers, 24, **kw)
    tt, to, trep = tp.dgro_place(servers, 24, device="cpu", **kw)
    assert trep == jrep
    fixed = dict(fixed_salt=trep["salt"], fixed_moves=trep["moves"])
    rt, ro, rrep = tp.dgro_place(servers, 24, device="cpu", **fixed)
    assert np.array_equal(rt, tt) and np.array_equal(ro, to)
    assert rrep == {"salt": trep["salt"], "moves": trep["moves"], "rescored": False}
    # after a membership change the replay keeps the survivors' overrides
    later = servers[2:] + _servers(3, 4)
    jrt, jro, jrr = jp.dgro_place(later, 24, fixed_salt=jrep["salt"], fixed_moves=jrep["moves"])
    prt, pro, prr = tp.dgro_place(later, 24, device="cpu", **fixed)
    assert np.array_equal(prt, jrt) and np.array_equal(pro, jro) and prr == jrr
    # a salted candidate replays too
    for salt in (0, int(jp._SALT_STRIDE), int(np.uint32(3 * int(jp._SALT_STRIDE) % 2**32))):
        a = jp.dgro_place(later, 24, fixed_salt=salt)
        b = tp.dgro_place(later, 24, fixed_salt=salt, device="cpu")
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]


def test_key_movement_matches_jax():
    a_srv = _servers(10, 5)
    b_srv = a_srv[1:] + _servers(2, 6)
    ta, oa, _ = jp.dgro_place(a_srv, 16, candidates=3, probes=500, seed=1)
    tb, ob, _ = jp.dgro_place(b_srv, 16, candidates=3, probes=500, seed=1)
    hashes = np.random.default_rng(2).integers(0, 2**32, size=4001, dtype=np.uint32)
    want = jp.key_movement(ta, oa, a_srv, tb, ob, b_srv, jnp.asarray(hashes))
    got = tp.key_movement(ta, oa, a_srv, tb, ob, b_srv, hashes, device="cpu")
    assert got == want and got["moved_frac"] > 0


def test_ringstore_dgro_records_match_jax():
    """update, drain and rescore commits under ``placement="dgro"``: the
    records, the placement report, the committed host arrays and the fused
    LookupN answers equal the JAX RingStore's at every generation."""
    kw = dict(replica_points=32, placement="dgro", placement_kw={"candidates": 3, "probes": 1000})
    servers = _servers(8, 9)
    tstore = tst.RingStore(servers, device="cpu", **kw)
    jstore = jst.RingStore(servers, **kw)
    assert tstore.placement_report == jstore.placement_report
    hashes = np.random.default_rng(3).integers(0, 2**32, size=2048, dtype=np.uint32)
    steps = [
        lambda s: s.update(add=_servers(2, 10), remove=servers[:1]),
        lambda s: s.drain([servers[3]]),
        lambda s: s.rescore_placement(),
        lambda s: s.update(add=[servers[0]]),
        lambda s: s.drain(["not-a-member"]),
    ]
    for i, step in enumerate([None] + steps):
        if step is not None:
            assert step(tstore) == step(jstore), f"step {i}"
        th, to, tgen, tns = tstore.snapshot_host()
        jh, jo, jgen, jns = jstore.snapshot_host()
        assert (tgen, tns) == (jgen, jns)
        assert np.array_equal(th, jh) and np.array_equal(to, jo)
        ring, gen, ns = tstore.snapshot()
        jring, _, _ = jstore.snapshot()
        got = tst.serve_lookup_n_fused(ring, ns, torch.from_numpy(hashes.astype(np.int64)), 3).numpy()
        want = np.asarray(jst.serve_lookup_n_fused(jring, jns, jnp.asarray(hashes), 3))
        assert np.array_equal(got, want) and int(got[-1]) == gen
    assert tstore._dgro_salt == jstore._dgro_salt and tstore._dgro_moves == jstore._dgro_moves
    assert tstore.placement_report == jstore.placement_report
    # random placement: rescore is a no-op, as in the JAX package
    assert tst.RingStore(servers, replica_points=8, device="cpu").rescore_placement() is None


def test_dgro_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda d: tp.dgro_place(_servers(4), 8, candidates=2, probes=64, device=d),
                 lambda d: tst.RingStore(_servers(4), replica_points=8, placement="dgro",
                                         placement_kw={"candidates": 2, "probes": 64}, device=d),
                 lambda d: tp.key_movement(np.array([5], np.uint32), np.array([0], np.int32), ["a"],
                                           np.array([5], np.uint32), np.array([0], np.int32), ["a"],
                                           np.array([1], np.uint32), device=d)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(None)
        call("cpu")
