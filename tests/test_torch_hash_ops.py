"""The PyTorch port's Fingerprint32 against the JAX package, bit for bit.

The same seeded key corpus goes through the port's plain PyTorch version
(``ringpop_tpu_torch.ops.hash_ops.fingerprint32_device``, the CPU path of
the CUDA kernel's wrapper), the JAX ``fingerprint32_device``, the JAX Pallas
kernel in interpret mode and the port's scalar farm copy.  Every output is
an integer hash: the tolerance is none.
"""

import numpy as np
import pytest
import torch

from ringpop_tpu.hashing.farm import fingerprint32 as jax_pkg_scalar
from ringpop_tpu.ops.hash_ops import fingerprint32_device as jax_fingerprint32
from ringpop_tpu.ops.hash_ops import keyed_owner_lookup as jax_keyed_owner_lookup
from ringpop_tpu.ops.hash_pallas import fingerprint32_pallas
from ringpop_tpu.ops.ring_ops import build_ring_tokens as jax_build_ring_tokens

from ringpop_tpu_torch.hashing import farm
from ringpop_tpu_torch.ops import hash_kernel, hash_ops
from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens


def _corpus(seed=0, n_rand=4):
    """tests/test_hash_ops.py's corpus — every length class boundary and
    loop counts 1..6 of random bytes (>= 0x80 included), realistic ring
    keys — plus UTF-8 keys and the empty string."""
    rng = np.random.default_rng(seed)
    strings = []
    for L in list(range(0, 26)) + [30, 40, 41, 60, 61, 80, 99, 100, 120, 127]:
        for _ in range(n_rand):
            strings.append(bytes(rng.integers(0, 256, size=L, dtype=np.uint8)))
    strings += [f"10.3.{i % 256}.{i % 40}:31{i % 100:02d}#{i}".encode() for i in range(128)]
    strings += [s.encode() for s in ("", "é", "key-éÅ", "ключ:ø", "鍵" * 9, "🔑" * 7)]
    return strings


def _plain(mat, lens):
    return hash_ops.fingerprint32_device(torch.from_numpy(mat), torch.from_numpy(lens)).numpy()


# (rows dropped from the end, extra zero columns): B not a multiple of 256
# or 32, widths not a multiple of 4
@pytest.mark.parametrize("drop,extra", [(0, 0), (1, 1), (7, 2), (33, 3)])
def test_plain_matches_jax_and_scalar(drop, extra):
    strings = _corpus(seed=2 + drop)
    strings = strings[: len(strings) - drop]
    mat, lens = farm.pack_strings(strings)
    mat = np.pad(mat, ((0, 0), (0, extra)))
    got = _plain(mat, lens)
    assert got.dtype == np.int64
    want_scalar = np.array([farm.fingerprint32(s) for s in strings], dtype=np.int64)
    want_jax = np.asarray(jax_fingerprint32(mat, lens)).astype(np.int64)
    assert np.array_equal(got, want_scalar)
    assert np.array_equal(got, want_jax)
    assert all(jax_pkg_scalar(s) == farm.fingerprint32(s) for s in strings[::7])


def test_plain_matches_pallas_interpret():
    strings = _corpus(seed=3)[:-5]  # B = 271: not a block multiple
    mat, lens = farm.pack_strings(strings)
    want = np.asarray(fingerprint32_pallas(mat, lens, interpret=True)).astype(np.int64)
    assert np.array_equal(_plain(mat, lens), want)


def test_plain_high_bytes_every_length():
    """Every length 0..130 with bytes >= 0x80 only: the signed-char leg of
    the 0-4 class and unaligned little-endian fetches at every offset."""
    rng = np.random.default_rng(5)
    strings = [bytes(rng.integers(128, 256, size=L, dtype=np.uint8)) for L in range(131)]
    mat, lens = farm.pack_strings(strings)
    want = np.array([farm.fingerprint32(s) for s in strings], dtype=np.int64)
    assert np.array_equal(_plain(mat, lens), want)
    assert np.array_equal(farm.fingerprint32_batch(mat, lens).astype(np.int64), want)


_HELPERS = [
    ("ror17", lambda v: hash_ops._ror(v, 17), lambda v: farm._ror(v, 17)),
    ("ror19", lambda v: hash_ops._ror(v, 19), lambda v: farm._ror(v, 19)),
    ("fmix", hash_ops._fmix, farm._fmix),
    ("mur", lambda v: hash_ops._mur(v, v ^ 0xFFFFFFFF), lambda v: farm._mur(v, v ^ 0xFFFFFFFF)),
]


@pytest.mark.parametrize("name,port,ref", _HELPERS, ids=[h[0] for h in _HELPERS])
def test_uint32_helpers_near_wrap(name, port, ref):
    """int64-held uint32 arithmetic at values near 2**32 - 1, where an int64
    product wraps past 2**63 and a rotate crosses the sign bit."""
    vals = [0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 3, 2**32 - 2, 2**32 - 1]
    vals += np.random.default_rng(9).integers(2**32 - 2**20, 2**32, size=24).tolist()
    got = port(torch.tensor(vals, dtype=torch.int64)).tolist()
    assert got == [ref(v) for v in vals]


def test_keyed_owner_lookup_matches_jax():
    servers = [f"10.0.0.{i}:3000" for i in range(24)]
    keys = [f"user:{i}:{i * 37}" for i in range(500)] + [f"trip:{i:032x}" for i in range(300)]
    mat, lens = farm.pack_strings(keys)
    jt, jo = jax_build_ring_tokens(servers, 100)
    want = np.asarray(jax_keyed_owner_lookup(jt, jo, mat, lens))
    tokens, owners = build_ring_tokens(servers, 100, device="cpu")
    dmat, dlens = hash_ops.upload_keys(mat, lens, device="cpu")
    got = hash_ops.keyed_owner_lookup(tokens, owners, dmat, dlens)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_wrapper_takes_plain_version_on_cpu_only():
    """The wrapper follows its input's device: a CPU tensor gets the plain
    version (no launch counted), int64 lens are accepted."""
    mat, lens = farm.pack_strings([b"a", b"0123456789abcdef0123456789"])
    before = hash_kernel.launches
    got = hash_kernel.fingerprint32(torch.from_numpy(mat), torch.from_numpy(lens))
    assert got.tolist() == [farm.fingerprint32(b"a"), farm.fingerprint32(b"0123456789abcdef0123456789")]
    assert hash_kernel.launches == before


def test_kernel_launcher_raises_without_card(monkeypatch, tmp_path):
    """Calling the kernel launcher on a box with no card raises — it never
    returns the plain result — and so does building without nvcc."""
    mat, lens = farm.pack_strings([b"key"])
    with pytest.raises(ValueError, match="CUDA"):
        hash_kernel.fingerprint32_cuda(torch.from_numpy(mat), torch.from_numpy(lens))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(hash_kernel, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        hash_kernel.build()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize(
    "mat,lens",
    [
        (np.zeros((2, 8), np.int32), np.zeros(2, np.int64)),  # not uint8
        (np.zeros((2, 3), np.uint8), np.zeros(2, np.int64)),  # W < 4
        (np.zeros((2, 8), np.uint8), np.zeros(3, np.int64)),  # B mismatch
        (np.zeros((2, 8), np.uint8), np.zeros(2, np.float32)),  # lens not integer
    ],
)
def test_key_matrix_contract(mat, lens):
    with pytest.raises(ValueError):
        hash_ops.fingerprint32_device(torch.from_numpy(mat), torch.from_numpy(lens))
