"""The packed-plane substrate: PyTorch port against the JAX package.

Every public function of ``ringpop_tpu_torch.sim.packbits`` on random
planes, bit for bit against ``ringpop_tpu.sim.packbits`` on the CPU, at
K in {1, 31, 32, 33, 40, 64, 128} (tail bits zero).  Planes cross as int32
bit patterns (``np.asarray(x).view(np.int32)``).  Also: the hazards of
int32 ``>>`` (arithmetic) on words with bit 31 set, a scatter's dropped
out-of-range rows, ``flat_index_u32`` across the 2**31 and 2**32 wraps,
and the kernel wrapper (``ops/packbits_kernel.py``): importing it builds
nothing, and a tensor that is not on the CPU reaches the kernel or an
error, never the plain version.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import packbits as jp

from ringpop_tpu_torch.ops import packbits_kernel
from ringpop_tpu_torch.sim import packbits as tp

REPO = Path(__file__).resolve().parent.parent
KS = [1, 31, 32, 33, 40, 64, 128]
M32 = 0xFFFFFFFF


def _bools(seed, shape, density=0.5):
    return np.random.default_rng(seed).random(shape) < density


def _plane(words_u32):
    """JAX uint32 plane -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(np.asarray(words_u32).view(np.int32).copy())


def _same(t, j):
    """A port int32 plane holds the JAX uint32 plane's bits."""
    t = t.numpy()
    return t.dtype == np.int32 and np.array_equal(t.view(np.uint32), np.asarray(j))


@pytest.mark.parametrize("k", KS)
def test_pack_unpack_match_jax(k):
    for shape in ((37, k), (3, 5, k), (k,)):
        b = _bools(k, shape)
        jpk = jp.pack_bool(jnp.asarray(b))
        tpk = tp.pack_bool(torch.from_numpy(b))
        assert tpk.shape == shape[:-1] + (tp.n_words(k),)
        assert _same(tpk, jpk)
        # tail bits past k are zero
        assert not tp.unpack_bits(tpk, 32 * tp.n_words(k))[..., k:].any()
        back = tp.unpack_bits(tpk, k)
        assert back.dtype == torch.bool and np.array_equal(back.numpy(), b)
        assert np.array_equal(back.numpy(), np.asarray(jp.unpack_bits(jpk, k)))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", [1, 3, 16, 17, 100, 4099])
def test_row_ops_match_jax(k, n):
    """popcount_rows, both reduces (with and without a row mask),
    nonzero_rows and row_mask on sparse, dense and random planes."""
    q = 1.0 - 0.5 ** (1.0 / n)
    rows = _bools(n + 1, n)
    for density in (q, 0.5, 1.0 - q):
        b = _bools(n * 1000 + k, (n, k), density)
        b[n // 2] = False  # one zero row for nonzero_rows
        jpk = jp.pack_bool(jnp.asarray(b))
        p = _plane(jpk)
        assert np.array_equal(tp.popcount_rows(p).numpy(), np.asarray(jp.popcount_rows(jpk)).astype(np.int32))
        assert tp.popcount_rows(p).dtype == torch.int32
        assert _same(tp.or_reduce_rows(p), jp.or_reduce_rows(jpk))
        assert _same(tp.and_reduce_rows(p), jp.and_reduce_rows(jpk))
        jrows = jnp.asarray(rows)
        assert _same(tp.or_reduce_rows(p, torch.from_numpy(rows)),
                     jp.or_reduce_rows(jpk & jp.row_mask(jrows)))
        assert _same(tp.and_reduce_rows(p, torch.from_numpy(rows)),
                     jp.and_reduce_rows(jpk | jp.row_mask(~jrows)))
        for fill in (False, True):  # all-false and all-true masks
            m = np.full(n, fill)
            assert _same(tp.or_reduce_rows(p, torch.from_numpy(m)),
                         jp.or_reduce_rows(jpk & jp.row_mask(jnp.asarray(m))))
            assert _same(tp.and_reduce_rows(p, torch.from_numpy(m)),
                         jp.and_reduce_rows(jpk | jp.row_mask(~jnp.asarray(m))))
        assert np.array_equal(tp.nonzero_rows(p).numpy(), np.asarray(jp.nonzero_rows(jpk)))
    assert _same(tp.row_mask(torch.from_numpy(rows)), jp.row_mask(jnp.asarray(rows)))


def test_reduces_of_full_words_and_halving_tree_sizes():
    """Random full 32-bit words (bit 31 set in about half) at sizes that
    exercise the blocked tree's padding (n not a power of two, n < 16)."""
    rng = np.random.default_rng(5)
    for n in (5, 16, 1000):
        for w in (1, 4):
            words = rng.integers(0, 1 << 32, size=(n, w), dtype=np.uint64).astype(np.uint32)
            words[rng.random((n, w)) < 0.3] |= np.uint32(0x80000000)
            jw = jnp.asarray(words)
            p = _plane(words)
            assert _same(tp.or_reduce_rows(p), jp.or_reduce_rows(jw))
            assert _same(tp.and_reduce_rows(p), jp.and_reduce_rows(jw))
            assert np.array_equal(tp.popcount_rows(p).numpy(), np.asarray(jp.popcount_rows(jw)).astype(np.int32))


@pytest.mark.parametrize("k", KS)
def test_bit_column_matches_jax(k):
    b = _bools(7 * k, (50, k))
    jpk = jp.pack_bool(jnp.asarray(b))
    p = _plane(jpk)
    for j in sorted({0, k // 2, k - 1}):
        got = tp.bit_column(p, j)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), np.asarray(jp.bit_column(jpk, j)))
        assert np.array_equal(tp.bit_column(p, torch.tensor(j)).numpy(), b[:, j])
    js = np.random.default_rng(k).integers(0, k, size=50).astype(np.int32)
    got = tp.bit_column(p, torch.from_numpy(js))
    assert np.array_equal(got.numpy(), np.asarray(jp.bit_column(jpk, jnp.asarray(js))))
    assert np.array_equal(got.numpy(), b[np.arange(50), js])


def test_int32_shift_sign_extension_hazard():
    """Words with bit 31 set: int32 ``>>`` is arithmetic, so an unmasked
    shift would smear the sign bit into every higher slot.  unpack_bits,
    bit_column and set_bit read and write exactly one bit."""
    words = np.array([[0x80000000, 0xFFFFFFFF], [0x7FFFFFFF, 0x80000001]], np.uint32)
    p = _plane(words)
    want = np.asarray(jp.unpack_bits(jnp.asarray(words), 64))
    got = tp.unpack_bits(p, 64)
    assert np.array_equal(got.numpy(), want)
    assert got[0, :32].sum() == 1 and bool(got[0, 31])
    for j in (0, 30, 31, 32, 63):
        assert np.array_equal(tp.bit_column(p, j).numpy(), np.asarray(jp.bit_column(jnp.asarray(words), j)))
    zero = torch.zeros((2, 2), dtype=torch.int32)
    jzero = jnp.zeros((2, 2), jnp.uint32)
    rows, slots, on = np.array([0, 1]), np.array([31, 63]), np.array([True, True])
    got = tp.set_bit(zero, torch.from_numpy(rows), torch.from_numpy(slots), torch.from_numpy(on))
    assert _same(got, jp.set_bit(jzero, jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(on)))
    assert got.numpy().view(np.uint32).tolist() == [[0x80000000, 0], [0, 0x80000000]]
    got = tp.set_bit_per_row(zero, torch.from_numpy(slots), torch.from_numpy(on))
    assert _same(got, jp.set_bit_per_row(jzero, jnp.asarray(slots), jnp.asarray(on)))


@pytest.mark.parametrize("k", [33, 64, 128])
def test_set_bit_matches_jax_and_drops_out_of_range_rows(k):
    """Distinct (row, slot) pairs into a random plane, with rows past the
    end and negative rows: JAX's scatter counts a negative index from the
    end and drops what is still out of range; the port does the same."""
    n = 40
    rng = np.random.default_rng(k)
    base = jp.pack_bool(jnp.asarray(_bools(k, (n, k), 0.2)))
    pairs = rng.choice(n * k, size=60, replace=False)
    rows, slots = (pairs // k).astype(np.int32), (pairs % k).astype(np.int32)
    rows[:6] = [n, n + 5, -1, -n, -n - 1, 2 * n]  # in range only after the wrap: -1, -n
    on = rng.random(60) < 0.8
    want = jp.set_bit(base, jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(on))
    got = tp.set_bit(_plane(base), torch.from_numpy(rows), torch.from_numpy(slots), torch.from_numpy(on))
    assert _same(got, want)
    # dropped rows really are dropped: all-out-of-range leaves the plane as it was
    out = np.array([n, n + 1, -n - 1], np.int32)
    got = tp.set_bit(_plane(base), torch.from_numpy(out), torch.zeros(3, dtype=torch.int32), torch.ones(3, dtype=torch.bool))
    assert _same(got, base)
    # a negative slot selects word -1 (the last) and bit 31, as in JAX
    got = tp.set_bit(_plane(base), torch.tensor([3]), torch.tensor([-1]), torch.tensor([True]))
    assert _same(got, jp.set_bit(base, jnp.asarray([3]), jnp.asarray([-1]), jnp.asarray([True])))


@pytest.mark.parametrize("k", KS)
def test_set_bit_per_row_matches_jax(k):
    n = 64
    rng = np.random.default_rng(k + 1)
    base = jp.pack_bool(jnp.asarray(_bools(k, (n, k), 0.3)))
    slots = rng.integers(0, k, size=n).astype(np.int32)
    on = rng.random(n) < 0.7
    want = jp.set_bit_per_row(base, jnp.asarray(slots), jnp.asarray(on))
    got = tp.set_bit_per_row(_plane(base), torch.from_numpy(slots), torch.from_numpy(on))
    assert _same(got, want)


def test_mix32_matches_jax_at_the_edges():
    xs = np.array([0, 1, 1 << 31, 0xFFFFFFFF, 0x7FFFFFFF, 0x85EBCA6B, 12345], np.uint32)
    xs = np.concatenate([xs, np.random.default_rng(0).integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(jp.mix32(jnp.asarray(xs)))
    got = tp.mix32(torch.from_numpy(xs.astype(np.int64)))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want.astype(np.int64))
    # the same words as int32 bit patterns (negative) and as torch.uint32:
    # uint32 has no >> on torch's CPU build, so mix32 widens first
    assert np.array_equal(tp.mix32(torch.from_numpy(xs.view(np.int32))).numpy(), want.astype(np.int64))
    assert np.array_equal(tp.mix32(torch.from_numpy(xs)).numpy(), want.astype(np.int64))
    assert int(tp.mix32(0xFFFFFFFF)) == int(want[3])


def test_flat_index_u32_across_the_wraps():
    """``row * ncols + col`` mod 2**32 where the numeric index crosses 2**31
    and 2**32 (16M x 256 sits at 2**32), against JAX and Python ints."""
    ncols = 256
    rows = np.array([0, (1 << 23) - 1, 1 << 23, (1 << 24) - 1, 1 << 24, (1 << 24) + 5, 16_000_000], np.int64)
    cols = np.array([0, 1, 127, 255], np.int64)
    r, c = np.meshgrid(rows, cols, indexing="ij")
    want = (r * ncols + c) % (1 << 32)
    got = tp.flat_index_u32(torch.from_numpy(r), ncols, torch.from_numpy(c))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    jwant = np.asarray(jp.flat_index_u32(jnp.asarray(r.astype(np.uint32)), ncols, jnp.asarray(c.astype(np.uint32))))
    assert np.array_equal(got.numpy(), jwant.astype(np.int64))
    # int32 operands (negative as uint32) and Python ints broadcast the same way
    r32 = np.array([-1, -(1 << 31), (1 << 31) - 1], np.int32)
    jw = np.asarray(jp.flat_index_u32(jnp.asarray(r32), 3, 7))
    assert np.array_equal(tp.flat_index_u32(torch.from_numpy(r32), 3, 7).numpy(), jw.astype(np.int64))
    assert int(tp.flat_index_u32(1 << 24, 256, 5)) == 5


def test_small_helpers():
    assert [tp.n_words(k) for k in (0, 1, 32, 33, 128)] == [jp.n_words(k) for k in (0, 1, 32, 33, 128)]
    for n in (1, 6, 16, 48, 1000, 4096, 1_000_000):
        assert tp.block_count(n, 16) == jp.block_count(n, 16)
    tp.check_rumor_shardable(128, 4)
    for k, s in ((96, 2), (40, 2)):
        with pytest.raises(ValueError, match="rumor axis"):
            tp.check_rumor_shardable(k, s)
        with pytest.raises(ValueError):
            jp.check_rumor_shardable(k, s)


def test_empty_planes():
    p = torch.zeros((0, 2), dtype=torch.int32)
    assert tp.or_reduce_rows(p).tolist() == [0, 0]
    assert tp.and_reduce_rows(p).tolist() == [-1, -1]
    assert tp.popcount_rows(p).shape == (0,)


# -- the kernel wrapper on a machine without a card ---------------------------


def test_import_builds_nothing(tmp_path):
    """Importing the kernel module (and the sim modules on top of it) needs
    neither nvcc nor a card: nothing is built or loaded until a CUDA tensor
    reaches a launcher."""
    code = (
        "import ringpop_tpu_torch.ops.packbits_kernel as k\n"
        "import ringpop_tpu_torch.sim.delta\n"
        "assert k._lib is None and k.launches == {'row_reduce': 0, 'popcount_rows': 0}\n"
        "print(k.vec_words(4, 256), k.vec_words(6, 256), k.vec_words(4, 260))\n"
    )
    env = {**os.environ, "PATH": str(tmp_path), "CUDA_HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["4", "2", "1"]


def test_vec_words():
    assert packbits_kernel.vec_words(4, 0) == 4
    assert packbits_kernel.vec_words(8, 16) == 4
    assert packbits_kernel.vec_words(8, 8) == 2
    assert packbits_kernel.vec_words(3, 16) == 1
    with pytest.raises(ValueError, match="aligned"):
        packbits_kernel.vec_words(4, 2)


@pytest.mark.parametrize("launch", [
    lambda p: packbits_kernel.reduce_rows_cuda(p, "or"),
    lambda p: packbits_kernel.reduce_rows_cuda(p, "and", torch.ones(p.shape[0], dtype=torch.bool)),
    packbits_kernel.popcount_rows_cuda,
])
def test_launchers_raise_on_cpu_tensors(launch):
    before = dict(packbits_kernel.launches)
    with pytest.raises(ValueError, match="CUDA"):
        launch(torch.zeros((4, 2), dtype=torch.int32))
    assert packbits_kernel.launches == before


@pytest.mark.parametrize("call", [
    lambda p: tp.or_reduce_rows(p),
    lambda p: tp.and_reduce_rows(p, torch.ones(p.shape[0], dtype=torch.bool, device=p.device)),
    tp.popcount_rows,
])
def test_device_tensor_without_a_card_raises(call, monkeypatch, tmp_path):
    """A tensor that is not on the CPU goes to the kernel, never to the
    plain version: here (no card, no nvcc) that is an error.  A meta tensor
    stands in for a CUDA one: first the launcher refuses it, then — with
    the device check waved through — the build fails for want of nvcc."""
    p = torch.empty((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        call(p)
    monkeypatch.setattr(packbits_kernel, "_check_plane", lambda p, what: None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(packbits_kernel, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(packbits_kernel, "_lib", None)
    before = dict(packbits_kernel.launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        call(p)
    assert packbits_kernel.launches == before
    assert not (tmp_path / "build").exists()


def test_reset_launches():
    packbits_kernel.launches["row_reduce"] += 3
    packbits_kernel.launches["popcount_rows"] += 1
    packbits_kernel.reset_launches()
    assert packbits_kernel.launches == {"row_reduce": 0, "popcount_rows": 0}
