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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# every width 4..10,000, in ten slices
@pytest.mark.parametrize("lo", range(4, 10_001, 1000))
def test_plan_tiles_every_width(lo):
    """The tile plan: a staged tile is a multiple of 32 rows (one thread per
    row, whole warps), so its span T*W is a multiple of 16 bytes (the
    copy's chunk); the ring fits a block's shared memory; and the wide
    route is taken exactly where a 32-row stage does not fit."""
    for width in range(lo, min(lo + 1000, 10_001)):
        rows, stages, smem, route = hash_kernel.plan_tiles(width)
        one_stage = hash_kernel.stage_bytes(32, width, hash_kernel.pad_shift(width))
        assert (route == "wide") == (one_stage > hash_kernel.SMEM_BUDGET), width
        if route == "wide":
            assert (rows, stages, smem) == (0, 0, 0)
            continue
        assert route == "staged"
        assert rows >= 32 and rows % 32 == 0 and rows <= 256, (width, rows)
        assert (rows * width) % 16 == 0
        assert 1 <= stages <= 2
        assert smem == stages * hash_kernel.stage_bytes(rows, width, hash_kernel.pad_shift(width))
        assert smem <= 232_448 and smem % (16 * stages) == 0, (width, smem)


def test_plan_tiles_main_path_widths():
    """The key widths a ring sees get full 256-row tiles and a ring of at
    least two stages; widths past ~6,450 bytes take the wide route."""
    for width in (20, 45, 64, 128, 256):
        rows, stages, _, route = hash_kernel.plan_tiles(width)
        assert (rows, route) == (256, "staged") and stages >= 2, width
    assert hash_kernel.plan_tiles(8200)[3] == "wide"
    assert hash_kernel.plan_tiles(45, smem_budget=16_000)[:2] == (160, 2)


@pytest.mark.parametrize("width,unskewed,skewed", [(45, 2, 2), (64, 16, 4), (128, 32, 4), (256, 32, 4)])
def test_pad_shift_spreads_a_warp_over_the_banks(width, unskewed, skewed):
    """Rows W bytes apart start in few banks when W is a multiple of 16; the
    chosen skew brings a warp's word loads to the 16-byte-chunk optimum
    (4-way) and leaves a width that needs none unpadded."""
    shift = hash_kernel.pad_shift(width)
    assert hash_kernel.bank_conflicts(width, hash_kernel.NO_PAD) == unskewed
    assert hash_kernel.bank_conflicts(width, shift) == skewed
    if unskewed == skewed:
        assert shift == hash_kernel.NO_PAD


@pytest.mark.parametrize("width", [4, 13, 45, 64, 128, 333])
@pytest.mark.parametrize("misalign", [0, 1, 15])
def test_stage_holds_every_byte_the_kernel_reads(width, misalign):
    """``stage_bytes`` covers the kernel's staged layout: a tile's span at
    logical offset ``misalign`` (the base's distance past a 16-byte
    boundary), each logical 16-byte chunk c at physical chunk
    c + (c >> pad_shift), and the aligned word after a row's last word."""
    rows, stages, smem, _ = hash_kernel.plan_tiles(width)
    shift = hash_kernel.pad_shift(width)
    words = smem // stages // 4
    last_word = (misalign + rows * width - 4) // 4 + 1  # logical word read last
    assert last_word + 4 * ((last_word >> 2) >> shift) < words


def test_reset_launches_zeroes_every_route():
    hash_kernel.route_launches["staged"] += 2
    hash_kernel.route_launches["wide"] += 1
    hash_kernel.launches += 3
    hash_kernel.reset_launches()
    assert hash_kernel.launches == 0
    assert hash_kernel.route_launches == {"staged": 0, "wide": 0}


def test_import_builds_nothing(tmp_path):
    """Importing the kernel module and planning tiles needs neither nvcc nor
    a card: nothing is built or loaded until a CUDA tensor is hashed."""
    import os
    import subprocess
    import sys

    code = (
        "import ringpop_tpu_torch.ops.hash_kernel as k\n"
        "assert k._lib is None\n"
        "print(k.plan_tiles(45))\n"
    )
    env = {**os.environ, "PATH": str(tmp_path), "CUDA_HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(hash_kernel.plan_tiles(45))


@pytest.mark.parametrize("lens_dtype", [np.int32, np.int64])
def test_kernel_launcher_raises_on_cpu_tensors(lens_dtype):
    mat, lens = farm.pack_strings([b"0123456789abcdef0123456789", b""])
    before = (hash_kernel.launches, dict(hash_kernel.route_launches))
    with pytest.raises(ValueError, match="CUDA"):
        hash_kernel.fingerprint32_cuda(torch.from_numpy(mat), torch.from_numpy(lens.astype(lens_dtype)))
    assert (hash_kernel.launches, hash_kernel.route_launches) == before
