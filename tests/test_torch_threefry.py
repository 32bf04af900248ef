"""The port's threefry stream against ``jax.random``, bit for bit.

``ringpop_tpu_torch.sim.threefry`` reproduces the draws the JAX package's
engines make (``rng="threefry"``): ``split`` (2, 3, 5 keys, chained),
``randint`` and ``uniform`` over seeds and shapes ``()``, ``(7,)``,
``(5, 3)`` and ``(1000, 3)``, the span edge cases (1, 2, n - 1, n, 2**31 - 1
and ``hi <= lo``), a span of 1,000,000 (where the span arithmetic's uint32
square wraps), the raw threefry2x32 on counters whose high word is not zero
(a draw of more than 2**32 values) and random keys and bounds under
hypothesis.  All on the CPU, the plain PyTorch path; the tolerance is
none.  Also: the CUDA launchers refuse a CPU key and a key that is not on
the CPU goes to the kernel, never to the plain version; the kernel's
remainder by a precomputed reciprocal, emulated step by step in numpy
uint64, is ``a % d``; the one-stream randint that the kernel draws when
the multiplier is 0 equals ``jax.random.randint``; the launcher hands the
kernel the variant and the reciprocal of the call's bounds.  ``fold_in``
equals ``jax.random.fold_in`` and ``split(key, d + 1)[d]``;
``categorical_masked`` equals ``jax.random.categorical`` over logits 0 /
-inf in the 2-D form and the ``(n, 3)``-from-``[n, 1, n]`` form, rows
with no allowed entry and ties included, drawn whole and a chunk of rows
at a time; and the premise of its exactness, that XLA's
``-log(-log(u))`` is strictly increasing over every uniform ``u`` the
draw takes, is checked where it can fail.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.extend.random import threefry2x32_p

from ringpop_tpu_torch.ops import threefry_kernel as tk
from ringpop_tpu_torch.sim import prng
from ringpop_tpu_torch.sim import threefry as tf

SEEDS = (0, 1, 7, 2**31 + 5, 2**32 - 1)
SHAPES = ((), (7,), (5, 3), (1000, 3))
N = 1_000_000
# (lo, hi): spans 1, 2, n - 1, n, 2**31 - 1, empty and inverted ranges, negatives
BOUNDS = ((0, 1), (0, 2), (0, N - 1), (1, N), (0, N), (0, 2**31 - 1), (5, 5), (10, 3),
          (-(2**31), 2**31 - 1), (-7, 100), (0, 65536), (0, 65537))


def _keys(seed):
    return jax.random.PRNGKey(seed), prng.prng_key(seed, "cpu")


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax_and_chains(seed):
    jk, tkey = _keys(seed)
    assert np.array_equal(_u32(jk), tkey.numpy())
    for num in (2, 3, 5):
        js, ts = jax.random.split(jk, num), tf.split(tkey, num)
        assert ts.dtype == torch.int64 and ts.shape == (num, 2)
        assert np.array_equal(_u32(js), ts.numpy()), num
    # chained splits: the engines split a key that came out of a split
    for _ in range(4):
        jk = jax.random.split(jk, 5)[4]
        tkey = tf.split(tkey, 5)[4]
        assert np.array_equal(_u32(jk), tkey.numpy())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_randint_matches_jax(seed, shape):
    jk, tkey = _keys(seed)
    for lo, hi in BOUNDS:
        want = np.asarray(jax.random.randint(jk, shape, lo, hi, dtype=jnp.int32))
        got = tf.randint(tkey, shape, lo, hi)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert np.array_equal(want, got.numpy()), (lo, hi)
        if hi <= lo:
            assert (got == lo).all()


def test_randint_span_of_a_million_wraps_in_uint32():
    """At a span of 1,000,000, ``2**16 mod span`` squared is 2**32, which
    wraps to 0 in uint32, so the multiplier is 0 and the draw is
    ``lower % span``; an unwrapped square would give other peers."""
    assert tk.span_multiplier(0, N) == (N, 0)
    assert tk.span_multiplier(0, 1000) == (1000, (65536 % 1000) ** 2 % 1000)
    jk, tkey = _keys(3)
    want = np.asarray(jax.random.randint(jk, (1000, 3), 0, N, dtype=jnp.int32))
    got = tf.randint(tkey, (1000, 3), 0, N).numpy()
    assert np.array_equal(want, got)
    keys = tf.split(tkey, 2)
    lower = tf.random_bits32(keys[1], (1000, 3))
    assert np.array_equal(got, (lower % N).numpy())
    higher = tf.random_bits32(keys[0], (1000, 3))
    unwrapped = ((higher % N) * ((65536 % N) ** 2 % N) + lower % N) % N
    assert not np.array_equal(got, unwrapped.numpy())


def test_randint_refuses_bounds_outside_int32():
    _, tkey = _keys(0)
    for lo, hi in ((0, 2**31), (-(2**31) - 1, 0)):
        with pytest.raises(ValueError, match="int32"):
            tf.randint(tkey, (3,), lo, hi)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_uniform_and_bits_match_jax(seed, shape):
    jk, tkey = _keys(seed)
    want = np.asarray(jax.random.uniform(jk, shape))
    got = tf.uniform(tkey, shape)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(want, got.numpy())
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0
    # XLA fuses the scale and shift into one multiply-add
    for mn, mx in ((0.25, 3.7), (-1.3, 0.1)):
        want = np.asarray(jax.random.uniform(jk, shape, minval=mn, maxval=mx))
        assert np.array_equal(want, tf.uniform(tkey, shape, mn, mx).numpy()), (mn, mx)
    want = _u32(jax.random.bits(jk, shape, jnp.uint32))
    assert np.array_equal(want, tf.random_bits32(tkey, shape).numpy())


def test_threefry2x32_on_counters_past_two_to_the_32():
    """A draw of more than 2**32 values has counters whose high word is not
    zero: the raw block cipher on explicit (hi, lo) words, held against the
    JAX primitive, and the flat-index split of the counters."""
    hi = np.array([0, 1, 1, 2, 7, 0xFFFF_FFFF], np.uint32)
    lo = np.array([0, 0, 5, 0xFFFF_FFFF, 123456, 0xFFFF_FFFF], np.uint32)
    for seed in SEEDS:
        jk, tkey = _keys(seed)
        k1, k2 = np.asarray(jk)
        want = threefry2x32_p.bind(jnp.uint32(k1), jnp.uint32(k2), jnp.asarray(hi), jnp.asarray(lo))
        got = tf.threefry2x32(tkey[0], tkey[1], torch.from_numpy(hi.astype(np.int64)),
                              torch.from_numpy(lo.astype(np.int64)))
        for w, g in zip(want, got):
            assert np.array_equal(_u32(w), g.numpy())
    c_hi, c_lo = tf.counters((3, 5))
    assert (c_hi == 0).all() and np.array_equal(c_lo.numpy(), np.arange(15).reshape(3, 5))


def test_counters_split_the_flat_index_into_words():
    flat = torch.tensor([0, 2**32 - 1, 2**32, 2**32 + 17, 5 * 2**32 + 3])
    hi, lo = flat >> 32, flat & 0xFFFF_FFFF
    assert hi.tolist() == [0, 0, 1, 1, 5] and lo.tolist() == [0, 2**32 - 1, 0, 17, 3]
    _, tkey = _keys(9)
    # the plain randint from bits at explicit counters equals the draw's own elements
    keys = tf.split(tkey, 2)
    h = tf.threefry2x32(keys[0][0], keys[0][1], torch.zeros(4, dtype=torch.int64), torch.arange(4))
    l_ = tf.threefry2x32(keys[1][0], keys[1][1], torch.zeros(4, dtype=torch.int64), torch.arange(4))
    assert torch.equal(tf.randint_from_bits(h[0] ^ h[1], l_[0] ^ l_[1], 0, 77), tf.randint(tkey, (4,), 0, 77))


@settings(max_examples=60, deadline=None)
@given(k1=st.integers(0, 2**32 - 1), k2=st.integers(0, 2**32 - 1),
       lo=st.integers(-(2**31), 2**31 - 1), span=st.integers(-5, 2**32 + 5),
       size=st.integers(0, 40))
def test_random_keys_and_bounds_match_jax(k1, k2, lo, span, size):
    hi = max(-(2**31), min(2**31 - 1, lo + span))
    jk = jnp.asarray([k1, k2], jnp.uint32)
    tkey = torch.tensor([k1, k2], dtype=torch.int64)
    want = np.asarray(jax.random.randint(jk, (size,), lo, hi, dtype=jnp.int32))
    assert np.array_equal(want, tf.randint(tkey, (size,), lo, hi).numpy())
    assert np.array_equal(np.asarray(jax.random.uniform(jk, (size,))), tf.uniform(tkey, (size,)).numpy())
    assert np.array_equal(_u32(jax.random.split(jk, 3)), tf.split(tkey, 3).numpy())


def test_draws_refuse_a_key_that_is_not_raw():
    for bad in (torch.zeros(3, dtype=torch.int64), torch.zeros(2, dtype=torch.int32)):
        with pytest.raises(ValueError, match="raw key"):
            tf.split(bad, 2)
        with pytest.raises(ValueError, match="raw key"):
            tf.randint(bad, (), 0, 5)


@pytest.mark.parametrize("call", [
    lambda key: tk.split_cuda(key, 3),
    lambda key: tk.bits_cuda(key, (4,)),
    lambda key: tk.randint_cuda(key, (4,), 0, 10),
    lambda key: tk.uniform_cuda(key, (4,)),
    lambda key: tk.fold_in_cuda(key, 1),
    lambda key: tk.categorical_cuda(key, torch.ones((3, 5), dtype=torch.bool, device=key.device), 3),
], ids=["split", "bits", "randint", "uniform", "fold_in", "categorical"])
def test_launchers_refuse_non_cuda_and_never_fall_back(call, monkeypatch, tmp_path):
    """A CPU key is refused by the launcher; a key that is not on the CPU
    goes to the kernel, never to the plain version: here (no card, no nvcc)
    that is an error, and nothing is counted.  A meta tensor stands in for
    a CUDA one."""
    with pytest.raises(ValueError, match="CUDA"):
        call(torch.zeros(2, dtype=torch.int64))
    key = torch.empty(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        call(key)
    monkeypatch.setattr(tk, "_check_key", lambda key, what: None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(tk, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tk, "_lib", None)
    before = dict(tk.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        call(key)
    assert tk.launches == before
    assert not (tmp_path / "build").exists()


def test_dispatch_goes_by_the_key_device(monkeypatch):
    """A key off the CPU is handed to the launcher (and never to the plain
    version); a CPU key never reaches a launcher."""
    seen = []
    for name in ("split_cuda", "bits_cuda", "randint_cuda", "uniform_cuda"):
        monkeypatch.setattr(tk, name, lambda key, *a, _n=name: seen.append(_n) or "kernel")
    for name in ("split_plain", "random_bits32_plain", "randint_plain", "uniform_plain"):
        monkeypatch.setattr(tf, name, lambda *a, _n=name: pytest.fail(f"{_n} on a card key"))
    meta = torch.empty(2, dtype=torch.int64, device="meta")
    assert tf.split(meta, 3) == tf.random_bits32(meta, (2,)) == tf.randint(meta, (), 0, 4) == \
        tf.uniform(meta, ()) == "kernel"
    assert seen == ["split_cuda", "bits_cuda", "randint_cuda", "uniform_cuda"]


M32 = np.uint64(0xFFFF_FFFF)
DIVISORS = (1, 2, 3, 7, 1000, 65535, 65536, 65537, 999999, 1000000, 2**31 - 1, 2**31, 2**32 - 1)


def _remainder_as_the_kernel(a, d) -> np.ndarray:
    """``a % d`` through the integer steps of ``remainder`` in
    ``csrc/threefry.cu``, each wrapped to uint32 as the card does, with
    ``d``'s :func:`reciprocal` (``a`` and ``d`` broadcast together)."""
    a, d = np.broadcast_arrays(np.asarray(a, np.uint64), np.asarray(d, np.uint64))
    magic, add, shift1, shift2 = (np.array(v, np.uint64).reshape(d.shape)
                                  for v in zip(*map(tk.reciprocal, d.ravel().tolist())))
    q = (magic * a) >> np.uint64(32)  # __umulhi
    q = np.where(add.astype(bool), (q + (((a - q) & M32) >> shift1)) & M32, q)
    return (a - (((q >> shift2) * d) & M32)) & M32


@pytest.mark.parametrize("d", DIVISORS)
def test_reciprocal_remainder_at_the_corner_dividends(d):
    # the largest multiple of d in uint32 less 1: where a 32-bit magic number
    # too short for d (one that needs the add indicator) first errs
    top = (2**32 - 1) // d * d
    a = np.array([0, 1, d - 1, d, d + 1, 2**32 - 1, top - 1, top], np.uint64) & M32
    assert np.array_equal(_remainder_as_the_kernel(a, d), a % np.uint64(d))
    magic, add, shift1, shift2 = tk.reciprocal(d)
    assert 0 <= magic < 2**32 and 0 <= shift1 <= 1 and 0 <= shift2 < 32


def test_reciprocal_remainder_at_random_pairs():
    rng = np.random.default_rng(20261017)
    a = rng.integers(0, 2**32, 100_000, dtype=np.uint64)
    d = rng.integers(1, 2**32, 100_000, dtype=np.uint64)
    # a third of the divisors below 2**16, where randint's two-stream variant lives
    d[::3] = rng.integers(1, 2**16 + 1, d[::3].size, dtype=np.uint64)
    assert np.array_equal(_remainder_as_the_kernel(a, d), a % d)


@settings(max_examples=300, deadline=None)
@given(a=st.integers(0, 2**32 - 1), d=st.integers(1, 2**32 - 1))
def test_reciprocal_remainder_hypothesis(a, d):
    assert int(_remainder_as_the_kernel(a, d)) == a % d


def test_reciprocal_refuses_divisors_outside_uint32():
    for d in (0, 2**32, -1):
        with pytest.raises(ValueError, match="divisor"):
            tk.reciprocal(d)


@pytest.mark.parametrize("lo,hi,dead", [
    (0, 65536, True), (0, 65537, True), (0, 1024, True), (0, N - 1, True), (0, N, True),
    (0, 1000, False), (0, 65535, False),
])
def test_one_stream_randint_where_the_multiplier_is_zero(lo, hi, dead):
    """Where ``span_multiplier`` gives 0, ``higher`` does not reach the
    output: ``lo + lower % span`` from the second subkey alone equals
    ``jax.random.randint``, which is what the kernel's one-stream variant
    draws.  Spans 1000 and 65535 keep both streams."""
    span, mult, two_streams, _ = tk.randint_variant(lo, hi)
    assert (mult == 0) == dead and two_streams == (not dead)
    for seed in (0, 5):
        jk, tkey = _keys(seed)
        for shape in ((7,), (40, 3)):
            want = np.asarray(jax.random.randint(jk, shape, lo, hi, dtype=jnp.int32))
            lower = tf.random_bits32(tf.split(tkey, 2)[1], shape)
            one_stream = (lo + lower % span).to(torch.int32)
            assert np.array_equal(want, one_stream.numpy()) == dead, (seed, shape)


@pytest.mark.parametrize("lo,hi", [(0, N), (0, N - 1), (0, 1000), (0, 7), (9, 3), (-(2**31), 2**31 - 1)])
def test_randint_launcher_passes_the_variant_and_reciprocal(lo, hi, monkeypatch):
    """The launcher hands the kernel the call's bounds, its multiplier, the
    variant (two streams only where the multiplier is not 0) and the span's
    reciprocal; a stub library stands in for the built one."""
    calls = []

    def rp_threefry_randint(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(tk, "_library", lambda: types.SimpleNamespace(rp_threefry_randint=rp_threefry_randint))
    monkeypatch.setattr(tk, "_check_key", lambda key, what: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    before = tk.launches["randint"]
    out = tk.randint_cuda(torch.empty(2, dtype=torch.int64, device="meta"), (5, 3), lo, hi)
    assert out.shape == (5, 3) and out.dtype == torch.int32 and tk.launches["randint"] == before + 1
    (args,) = calls
    span, mult = tk.span_multiplier(lo, hi)
    assert args[1:-2] == (15, lo, span, mult, mult != 0, *tk.reciprocal(span))


def test_reset_launches():
    tk.launches["randint"] = 3
    tk.reset_launches()
    assert tk.launches == {"split": 0, "bits": 0, "randint": 0, "uniform": 0, "fold_in": 0, "categorical": 0}


FOLD_DATA = (0, 1, 5, 2**31 - 1, 2**32 - 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax_and_split(seed):
    jk, tkey = _keys(seed)
    for depth in range(3):
        for d in FOLD_DATA:
            got = tf.fold_in(tkey, d)
            assert got.dtype == torch.int64 and got.shape == (2,)
            assert np.array_equal(_u32(jax.random.fold_in(jk, d)), got.numpy()), (depth, d)
            if d < 8:
                assert torch.equal(got, tf.split(tkey, d + 1)[d])
        jk, tkey = jax.random.split(jk, 4)[3], tf.split(tkey, 4)[3]
    for bad in (-1, 2**32):
        with pytest.raises(ValueError, match="fold_in takes data"):
            tf.fold_in(tkey, bad)


def _jax_categorical(jk, mask, reps=None):
    """The JAX package's draw sites: safe logits (a row with nothing allowed
    draws over the whole row), then ``jax.random.categorical``."""
    mask = jnp.asarray(mask)
    logits = jnp.where(mask, 0.0, -jnp.inf)
    logits = jnp.where(mask.any(axis=1)[:, None], logits, 0.0)
    if reps is None:
        return np.asarray(jax.random.categorical(jk, logits, axis=1))
    n = mask.shape[0]
    return np.asarray(jax.random.categorical(jk, logits[:, None, :], axis=-1, shape=(n, reps)))


def _masks(n, cols, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for density in (0.01, 0.5, 0.99):
        m = rng.random((n, cols)) < density
        m[0] = False  # nothing allowed: the whole row
        m[1] = True
        m[2] = False
        m[2, -1] = True  # one allowed entry, the last
        out[density] = m
    return out


@pytest.mark.parametrize("reps", [None, 3])
@pytest.mark.parametrize("cols", [1, 31, 33, 257])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_categorical_masked_matches_jax(seed, cols, reps):
    jk, tkey = _keys(seed)
    jk, tkey = jax.random.split(jk, 4)[2], tf.split(tkey, 4)[2]
    for density, mask in _masks(40, cols, seed).items():
        want = _jax_categorical(jk, mask, reps)
        got = tf.categorical_masked(tkey, torch.as_tensor(mask), reps)
        assert got.dtype == torch.int32 and got.shape == want.shape, (got.shape, want.shape)
        assert np.array_equal(want, got.numpy()), density
        allowed = mask | ~mask.any(axis=1, keepdims=True)
        picked = got.numpy() if reps is None else got.numpy()[:, 0]
        assert allowed[np.arange(40), picked].all()


def test_categorical_masked_ties_go_to_the_first_index():
    """Two allowed entries whose 23-bit draws are equal: both the port and
    jax.random.categorical take the first."""
    jk, tkey = _keys(3)
    n = 16384  # ~16 equal pairs a row among 2**23 values
    bits = (tf.random_bits32(tkey, (2, n)) >> 9).numpy()
    found = 0
    for row in range(2):
        vals, first, counts = np.unique(bits[row], return_index=True, return_counts=True)
        for v in vals[counts > 1][:3]:
            j1, j2 = np.flatnonzero(bits[row] == v)[:2]
            mask = np.zeros((2, n), bool)
            mask[row, [j1, j2]] = True
            mask[1 - row, 7] = True
            got = tf.categorical_masked(tkey, torch.as_tensor(mask)).numpy()
            assert got[row] == j1 and np.array_equal(_jax_categorical(jk, mask), got)
            found += 1
    assert found >= 2


def test_categorical_masked_in_chunks_and_by_rows(monkeypatch):
    """Chunks of one row and of a few rows, and ``rows=`` drawing rows of
    the whole draw alone, give the whole draw's answers."""
    jk, tkey = _keys(1)
    mask = _masks(30, 50, 1)[0.5]
    want = _jax_categorical(jk, mask, 3)
    for chunk in (1, 150, 449):
        monkeypatch.setattr(tf, "CATEGORICAL_CHUNK", chunk)
        assert np.array_equal(want, tf.categorical_masked(tkey, torch.as_tensor(mask), 3).numpy()), chunk
    rows = torch.tensor([29, 0, 13])
    got = tf.categorical_masked_plain(tkey, torch.as_tensor(mask), 3, rows=rows)
    assert np.array_equal(want[rows.numpy()], got.numpy())
    got1 = tf.categorical_masked_plain(tkey, torch.as_tensor(mask), None, rows=rows)
    assert np.array_equal(_jax_categorical(jk, mask)[rows.numpy()], got1.numpy())


def test_categorical_masked_refuses_logits_and_bad_shapes():
    key = prng.prng_key(0, "cpu")
    with pytest.raises(TypeError, match="bool mask.*general logits"):
        tf.categorical_masked(key, torch.zeros((3, 4)))
    with pytest.raises(ValueError, match=r"mask \[R, N\]"):
        tf.categorical_masked(key, torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="reps"):
        tf.categorical_masked(key, torch.zeros((3, 4), dtype=torch.bool), 0)


def test_gumbel_is_strictly_increasing_over_every_uniform():
    """The premise of C1's exactness: jax.random.categorical's Gumbel noise
    ``-log(-log(u))``, with ``u = uniform(minval=tiny)`` (mode "low", the
    default), is strictly increasing in the draw's top 23 bits over all
    2**23 values they take, so its argmax is the argmax of those bits."""
    from jax._src import random as jrandom

    tiny = jnp.finfo(jnp.float32).tiny

    @jax.jit
    def gumbel_of(mantissa):
        floats = jax.lax.bitcast_convert_type(mantissa | jnp.uint32(0x3F800000), jnp.float32) - 1.0
        u = jax.lax.max(tiny, floats * (jnp.float32(1.0) - tiny) + tiny)
        return -jnp.log(-jnp.log(u))

    g = np.asarray(gumbel_of(jnp.arange(2**23, dtype=jnp.uint32)))
    assert np.isfinite(g).all() and (np.diff(g) > 0).all()
    # and the formula above is the one the library draws with
    key = jax.random.PRNGKey(5)
    bits = jax.random.bits(key, (1000,), jnp.uint32)
    assert np.array_equal(np.asarray(jrandom.gumbel(key, (1000,))), np.asarray(gumbel_of(bits >> 9)))


def test_new_draws_dispatch_by_the_key_device(monkeypatch):
    seen = []
    monkeypatch.setattr(tk, "fold_in_cuda", lambda key, d: seen.append("fold_in") or "kernel")
    monkeypatch.setattr(tk, "categorical_cuda", lambda key, m, r: seen.append("categorical") or "kernel")
    monkeypatch.setattr(tf, "fold_in_plain", lambda *a: pytest.fail("plain fold_in on a card key"))
    monkeypatch.setattr(tf, "categorical_masked_plain", lambda *a: pytest.fail("plain categorical on a card key"))
    meta = torch.empty(2, dtype=torch.int64, device="meta")
    mask = torch.empty((2, 3), dtype=torch.bool, device="meta")
    assert tf.fold_in(meta, 1) == tf.categorical_masked(meta, mask, 3) == "kernel"
    assert seen == ["fold_in", "categorical"]


@pytest.mark.parametrize("reps", [None, 3])
def test_categorical_launcher_passes_the_mask_and_shape(reps, monkeypatch):
    calls = []
    monkeypatch.setattr(tk, "_library", lambda: types.SimpleNamespace(
        rp_threefry_categorical_rows=lambda *args: calls.append(args) or 0,
        rp_threefry_fold_in=lambda *args: calls.append(args) or 0))
    monkeypatch.setattr(tk, "_check_key", lambda key, what: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    key = torch.empty(2, dtype=torch.int64, device="meta")
    mask = torch.empty((7, 11), dtype=torch.bool, device="meta")
    before = dict(tk.launches)
    out = tk.categorical_cuda(key, mask, reps)
    assert out.dtype == torch.int32 and out.shape == ((7,) if reps is None else (7, reps))
    assert tk.fold_in_cuda(key, 2**32 - 1).shape == (2,)
    assert tk.launches["categorical"] == before["categorical"] + 1
    assert tk.launches["fold_in"] == before["fold_in"] + 1
    (cat, fold) = calls
    assert cat[2:5] == (7, 11, reps or 1) and len(cat) == 7
    assert fold[1] == 2**32 - 1 and len(fold) == 4
    with pytest.raises(ValueError, match="bool mask"):
        tk.categorical_cuda(key, mask.to(torch.int32), reps)
    with pytest.raises(ValueError, match="column"):
        tk.categorical_cuda(key, torch.empty((3, 0), dtype=torch.bool, device="meta"), reps)
    with pytest.raises(ValueError, match="2\\*\\*30 columns"):
        tk.categorical_cuda(key, torch.empty((1, 2**30 + 1), dtype=torch.bool, device="meta"), reps)
