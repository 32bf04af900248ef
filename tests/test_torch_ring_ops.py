"""The PyTorch port's ring-lookup ops against the JAX package, bit for bit.

The adversarial rings and probe keys of ``tests/test_ring_properties.py`` —
duplicate and adjacent tokens, long same-owner runs, keys on a token and
token±1, hash-space extremes — go through both packages: exact-size and
capacity-padded lookups, LookupN at every window configuration (forced
window overflow included), an empty ring, PAD_TOKEN-valued keys,
signed-dtype hashes >= 2**31, and the numpy ``host_lookup_n`` oracle.
Owner ids are integers: the tolerance is none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ringpop_tpu.ops import ring_ops as jro

from ringpop_tpu_torch.ops import ring_ops as tro


def _adversarial_ring(rng, t, num_servers):
    """(tokens uint32, owners int32) in composite (token, owner) order with
    long same-owner runs and duplicate tokens (test_ring_properties)."""
    owners = np.sort(rng.integers(0, num_servers, size=t)).astype(np.int32)
    rng.shuffle(owners[: t // 2])
    vals = (
        rng.integers(0, max(t // 3, 2), size=t).astype(np.uint64)
        * np.uint64(int(rng.integers(1, 2**26)))
    ) & np.uint64(0xFFFFFFFF)
    tokens = np.sort(vals).astype(np.uint32)
    order = jro.ring_composite_order(tokens, owners)
    return tokens[order], owners[order]


def _probe_keys(rng, tokens):
    return np.unique(
        np.concatenate(
            [
                rng.integers(0, 2**32, size=24, dtype=np.uint32),
                tokens,
                tokens + np.uint32(1),
                tokens - np.uint32(1),
                np.array([0, 1, 2**32 - 1, 2**32 - 2], dtype=np.uint32),
            ]
        ).astype(np.uint32)
    )


def _t(a):
    """Host array -> CPU tensor in the port's layout (uint32 -> int64)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def _trials(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        t = int(rng.integers(lo, hi))
        ns = int(rng.integers(1, 7))
        tokens, owners = _adversarial_ring(rng, t, ns)
        yield tokens, owners, _probe_keys(rng, tokens), ns


def test_composite_order_and_build_match_jax():
    rng = np.random.default_rng(40)
    toks = rng.integers(0, 50, size=200).astype(np.uint32)
    owners = rng.integers(0, 9, size=200).astype(np.int32)
    assert np.array_equal(tro.ring_composite_order(toks, owners), jro.ring_composite_order(toks, owners))
    servers = [f"10.1.{i // 8}.{i % 8}:3000" for i in range(40)]
    jt, jo = jro.build_ring_tokens(servers, 16)
    t, o = tro.build_ring_tokens(servers, 16, device="cpu")
    assert t.dtype == torch.int64 and o.dtype == torch.int32
    assert np.array_equal(t.numpy(), np.asarray(jt).astype(np.int64))
    assert np.array_equal(o.numpy(), np.asarray(jo))


@pytest.mark.parametrize("seed", [41, 141])
def test_lookup_and_lookup_n_match_jax(seed):
    for tokens, owners, keys, ns in _trials(seed, 3, 3, 48):
        jt, jo, jk = jnp.asarray(tokens), jnp.asarray(owners), jnp.asarray(keys)
        got1 = tro.ring_lookup(_t(tokens), _t(owners), _t(keys))
        assert np.array_equal(got1.numpy(), np.asarray(jro.ring_lookup(jt, jo, jk)))
        for n in (1, 2, ns, ns + 2):
            got = tro.ring_lookup_n(_t(tokens), _t(owners), _t(keys), n, ns)
            want = np.asarray(jro.ring_lookup_n(jt, jo, jk, n, ns))
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want), n
            assert np.array_equal(got.numpy(), jro.host_lookup_n(tokens, owners, keys, n, ns))


def test_lookup_n_every_window_config():
    """The windowed scan driven directly at every window size: output rows
    AND unique counts equal the JAX scan's, including partial windows."""
    rng = np.random.default_rng(42)
    t, ns = 24, 4
    tokens, owners = _adversarial_ring(rng, t, ns)
    keys = _probe_keys(rng, tokens)
    jt, jo, jk = jnp.asarray(tokens), jnp.asarray(owners), jnp.asarray(keys)
    for n in (1, 2, 4, 6):
        for w in sorted({1, 2, 3, n, t // 2, t}):
            out, found = tro._lookup_n_window(_t(tokens), _t(owners), _t(keys), n, w)
            jout, jfound = jro._lookup_n_window(jt, jo, jk, n, w)
            assert np.array_equal(out.numpy(), np.asarray(jout)), (n, w)
            assert np.array_equal(found.numpy(), np.asarray(jfound)), (n, w)


@pytest.mark.parametrize("extra_cap", [0, 3, 17])
def test_padded_variants_match_jax(extra_cap):
    for tokens, owners, keys, ns in _trials(43 + extra_cap, 2, 1, 40):
        pt, po, count = tro.pad_ring_arrays(tokens, owners, tokens.shape[0] + extra_cap)
        jpt, jpo, jcount = jro.pad_ring_arrays(tokens, owners, tokens.shape[0] + extra_cap)
        assert np.array_equal(pt, jpt) and np.array_equal(po, jpo) and count == jcount
        jc = jnp.asarray(count, jnp.int32)
        got1 = tro.ring_lookup_padded(_t(pt), _t(po), torch.tensor(count), _t(keys))
        want1 = jro.ring_lookup_padded(jnp.asarray(pt), jnp.asarray(po), jc, jnp.asarray(keys))
        assert np.array_equal(got1.numpy(), np.asarray(want1))
        for n in (1, 2, ns + 1):
            got = tro.ring_lookup_n_padded(_t(pt), _t(po), torch.tensor(count), ns, _t(keys), n)
            want = jro.ring_lookup_n_padded(
                jnp.asarray(pt), jnp.asarray(po), jc, jnp.asarray(ns, jnp.int32),
                jnp.asarray(keys), n,
            )
            assert np.array_equal(got.numpy(), np.asarray(want)), (extra_cap, n)
            for w in (1, pt.shape[0]):
                out, found = tro._lookup_n_window_padded(_t(pt), _t(po), count, _t(keys), n, w)
                jout, jfound = jro._lookup_n_window_padded(
                    jnp.asarray(pt), jnp.asarray(po), jc, jnp.asarray(keys), n, w
                )
                assert np.array_equal(out.numpy(), np.asarray(jout)), (extra_cap, n, w)
                assert np.array_equal(found.numpy(), np.asarray(jfound)), (extra_cap, n, w)


def test_padded_window_mod_count_not_capacity():
    pt, po, count = tro.pad_ring_arrays(np.array([10, 20, 30], np.uint32), np.array([0, 1, 2], np.int32), 8)
    out, found = tro._lookup_n_window_padded(_t(pt), _t(po), count, torch.tensor([25]), 3, 4)
    assert out.tolist() == [[2, 0, 1]] and found.tolist() == [3]


def test_empty_ring():
    keys = np.array([0, 1, 2**32 - 1], np.uint32)
    pt, po, count = tro.pad_ring_arrays(np.empty(0, np.uint32), np.empty(0, np.int32), 4)
    got = tro.ring_lookup_padded(_t(pt), _t(po), count, _t(keys))
    jgot = jro.ring_lookup_padded(
        jnp.asarray(pt), jnp.asarray(po), jnp.asarray(count, jnp.int32), jnp.asarray(keys)
    )
    assert got.tolist() == [-1, -1, -1] and np.array_equal(got.numpy(), np.asarray(jgot))
    gotn = tro.ring_lookup_n_padded(_t(pt), _t(po), count, 0, _t(keys), 2)
    assert (gotn == -1).all() and gotn.shape == (3, 2)
    exact = tro.ring_lookup_n(_t(np.empty(0, np.uint32)), _t(np.empty(0, np.int32)), _t(keys), 2, 0)
    assert (exact == -1).all() and exact.shape == (3, 2)
    host = tro.host_lookup_n(np.empty(0, np.uint32), np.empty(0, np.int32), keys[:1], 2, 0)
    assert host.shape == (1, 2) and (host == -1).all()


def test_keys_equal_to_pad_token():
    owners = np.array([0, 1], np.int32)
    key = _t(np.array([tro.PAD_TOKEN], np.uint32))
    for tokens, want in ((np.array([5, tro.PAD_TOKEN], np.uint32), 1), (np.array([5, 9], np.uint32), 0)):
        pt, po, count = tro.pad_ring_arrays(tokens, owners, 6)
        got = tro.ring_lookup_padded(_t(pt), _t(po), count, key)
        jgot = jro.ring_lookup_padded(
            jnp.asarray(pt), jnp.asarray(po), jnp.asarray(count, jnp.int32),
            jnp.asarray([tro.PAD_TOKEN], jnp.uint32),
        )
        assert got.tolist() == [want] == np.asarray(jgot).tolist()


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.uint32])
def test_signed_dtype_hashes_route_like_uint32(dtype):
    """Hashes >= 2**31 arriving int64, int32 (two's complement) or uint32
    route exactly like their uint32 value — never compared signed."""
    tokens = np.array([100, 2**31 + 5, 2**32 - 10], np.uint32)
    owners = np.array([0, 1, 2], np.int32)
    h = np.array([2**31 + 5, 2**31 + 6, 2**32 - 5, 50], dtype=np.int64)
    keys = torch.from_numpy(h.astype(np.uint32).astype(dtype))
    assert tro.ring_lookup(_t(tokens), _t(owners), keys).tolist() == [1, 2, 0, 0]
    an = tro.ring_lookup_n(_t(tokens), _t(owners), keys, 2, 3)
    jn = jro.ring_lookup_n(jnp.asarray(tokens), jnp.asarray(owners), jnp.asarray(h.astype(np.uint32)), 2, 3)
    assert np.array_equal(an.numpy(), np.asarray(jn))
    pt, po, count = tro.pad_ring_arrays(tokens, owners, 5)
    assert tro.ring_lookup_padded(_t(pt), _t(po), count, keys).tolist() == [1, 2, 0, 0]


def test_forced_window_overflow_rescue():
    """One owner's 93-token run hides the others past the first window:
    the host loop must double the window and still match JAX exactly."""
    t = 96
    owners = np.zeros(t, np.int32)
    owners[-3:] = [1, 2, 3]
    tokens = np.arange(t, dtype=np.uint32) * np.uint32(1000) + np.uint32(7)
    keys = np.array([0, 5, 500, 93_000], np.uint32)
    got = tro.ring_lookup_n(_t(tokens), _t(owners), _t(keys), 4, 4)
    want = jro.ring_lookup_n(jnp.asarray(tokens), jnp.asarray(owners), jnp.asarray(keys), 4, 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), tro.host_lookup_n(tokens, owners, keys, 4, 4))
    pt, po, count = tro.pad_ring_arrays(tokens, owners, t + 11)
    gotp = tro.ring_lookup_n_padded(_t(pt), _t(po), count, 4, _t(keys), 4)
    assert np.array_equal(gotp.numpy(), got.numpy())


def test_host_lookup_n_matches_jax_oracle():
    for tokens, owners, keys, ns in _trials(45, 4, 2, 32):
        for n in (1, 3, ns + 1):
            assert np.array_equal(
                tro.host_lookup_n(tokens, owners, keys, n, ns),
                jro.host_lookup_n(tokens, owners, keys, n, ns),
            )
