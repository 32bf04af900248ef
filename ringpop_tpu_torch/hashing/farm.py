"""FarmHash Fingerprint32 — platform-independent 32-bit fingerprint.

This is the hash the reference uses everywhere (``dgryski/go-farm``
Fingerprint32: ring tokens ``hashring/hashring.go:107``, membership checksum
``swim/memberlist.go:86``, facade ring ``ringpop.go:172``).  Fingerprint32 is
defined as the ``farmhashmk::Hash32`` routine of Google FarmHash, implemented
here from the published algorithm in two forms:

* :func:`fingerprint32` — pure-Python scalar, the semantic reference.
* :func:`fingerprint32_batch` — numpy-vectorized over a padded uint8 matrix,
  grouped by control-flow bucket (length class and >24-byte loop count), used
  to build million-server rings host-side in one shot.

Keeping the exact reference hash matters for wire/checksum compatibility with
existing ringpop deployments (checksum comparison drives full syncs,
``swim/disseminator.go:168-181``).

This module is a verbatim numpy copy of ``ringpop_tpu/hashing/farm.py``: the
PyTorch package imports nothing of the JAX package, so it keeps its own host
oracle and key packer.  It is the reference the port's plain PyTorch hash and
its CUDA kernel are held against.
"""

from __future__ import annotations

import numpy as np

_M32 = 0xFFFFFFFF
C1 = 0xCC9E2D51
C2 = 0x1B873593


def _ror(v: int, s: int) -> int:
    v &= _M32
    return ((v >> s) | (v << (32 - s))) & _M32


def _fmix(h: int) -> int:
    h &= _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return h


def _mur(a: int, h: int) -> int:
    a = (a * C1) & _M32
    a = _ror(a, 17)
    a = (a * C2) & _M32
    h ^= a
    h = _ror(h, 19)
    return (h * 5 + 0xE6546B64) & _M32


def _fetch32(data: bytes, i: int) -> int:
    return int.from_bytes(data[i : i + 4], "little")


def _hash32_len_0_to_4(data: bytes, seed: int = 0) -> int:
    b = seed
    c = 9
    for ch in data:
        v = ch - 256 if ch >= 128 else ch  # signed char semantics
        b = (b * C1 + v) & _M32
        c ^= b
    return _fmix(_mur(b, _mur(len(data), c)))


def _hash32_len_5_to_12(data: bytes, seed: int = 0) -> int:
    n = len(data)
    a = (n + 0) & _M32
    b = (n * 5) & _M32
    c = 9
    d = (b + seed) & _M32
    a = (a + _fetch32(data, 0)) & _M32
    b = (b + _fetch32(data, n - 4)) & _M32
    c = (c + _fetch32(data, (n >> 1) & 4)) & _M32
    return _fmix(seed ^ _mur(c, _mur(b, _mur(a, d))))


def _hash32_len_13_to_24(data: bytes, seed: int = 0) -> int:
    n = len(data)
    a = _fetch32(data, (n >> 1) - 4)
    b = _fetch32(data, 4)
    c = _fetch32(data, n - 8)
    d = _fetch32(data, n >> 1)
    e = _fetch32(data, 0)
    f = _fetch32(data, n - 4)
    h = (d * C1 + n + seed) & _M32
    a = (_ror(a, 12) + f) & _M32
    h = (_mur(c, h) + a) & _M32
    a = (_ror(a, 3) + c) & _M32
    h = (_mur(e, h) + a) & _M32
    a = (_ror((a + f) & _M32, 12) + d) & _M32
    h = (_mur(b ^ seed, h) + a) & _M32
    return _fmix(h)


def fingerprint32(data: bytes | str) -> int:
    """FarmHash Fingerprint32 of ``data`` (farmhashmk::Hash32)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    n = len(data)
    if n <= 4:
        return _hash32_len_0_to_4(data)
    if n <= 12:
        return _hash32_len_5_to_12(data)
    if n <= 24:
        return _hash32_len_13_to_24(data)

    h = n & _M32
    g = (C1 * n) & _M32
    f = g
    a0 = (_ror((_fetch32(data, n - 4) * C1) & _M32, 17) * C2) & _M32
    a1 = (_ror((_fetch32(data, n - 8) * C1) & _M32, 17) * C2) & _M32
    a2 = (_ror((_fetch32(data, n - 16) * C1) & _M32, 17) * C2) & _M32
    a3 = (_ror((_fetch32(data, n - 12) * C1) & _M32, 17) * C2) & _M32
    a4 = (_ror((_fetch32(data, n - 20) * C1) & _M32, 17) * C2) & _M32
    h ^= a0
    h = _ror(h, 19)
    h = (h * 5 + 0xE6546B64) & _M32
    h ^= a2
    h = _ror(h, 19)
    h = (h * 5 + 0xE6546B64) & _M32
    g ^= a1
    g = _ror(g, 19)
    g = (g * 5 + 0xE6546B64) & _M32
    g ^= a3
    g = _ror(g, 19)
    g = (g * 5 + 0xE6546B64) & _M32
    f = (f + a4) & _M32
    f = (_ror(f, 19) + 113) & _M32
    iters = (n - 1) // 20
    off = 0
    for _ in range(iters):
        a = _fetch32(data, off)
        b = _fetch32(data, off + 4)
        c = _fetch32(data, off + 8)
        d = _fetch32(data, off + 12)
        e = _fetch32(data, off + 16)
        h = (h + a) & _M32
        g = (g + b) & _M32
        f = (f + c) & _M32
        h = (_mur(d, h) + e) & _M32
        g = (_mur(c, g) + a) & _M32
        f = (_mur((b + (e * C1)) & _M32, f) + d) & _M32
        f = (f + g) & _M32
        g = (g + f) & _M32
        off += 20
    g = (_ror(g, 11) * C1) & _M32
    g = (_ror(g, 17) * C1) & _M32
    f = (_ror(f, 11) * C1) & _M32
    f = (_ror(f, 17) * C1) & _M32
    h = _ror((h + g) & _M32, 19)
    h = (h * 5 + 0xE6546B64) & _M32
    h = (_ror(h, 17) * C1) & _M32
    h = _ror((h + f) & _M32, 19)
    h = (h * 5 + 0xE6546B64) & _M32
    h = (_ror(h, 17) * C1) & _M32
    return h


# ---------------------------------------------------------------------------
# Vectorized batch version
# ---------------------------------------------------------------------------

_U32 = np.uint32


def _vror(v, s: int):
    v = v.astype(_U32)
    return ((v >> _U32(s)) | (v << _U32(32 - s))).astype(_U32)


def _vfmix(h):
    h = h.astype(_U32)
    h ^= h >> _U32(16)
    h = (h * _U32(0x85EBCA6B)).astype(_U32)
    h ^= h >> _U32(13)
    h = (h * _U32(0xC2B2AE35)).astype(_U32)
    h ^= h >> _U32(16)
    return h


def _vmur(a, h):
    a = (a.astype(_U32) * _U32(C1)).astype(_U32)
    a = _vror(a, 17)
    a = (a * _U32(C2)).astype(_U32)
    h = h.astype(_U32) ^ a
    h = _vror(h, 19)
    return (h * _U32(5) + _U32(0xE6546B64)).astype(_U32)


def _vfetch32(mat: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Little-endian 32-bit fetch at per-row byte offsets ``idx``."""
    r = np.arange(mat.shape[0])
    b0 = mat[r, idx].astype(_U32)
    b1 = mat[r, idx + 1].astype(_U32)
    b2 = mat[r, idx + 2].astype(_U32)
    b3 = mat[r, idx + 3].astype(_U32)
    return (b0 | (b1 << _U32(8)) | (b2 << _U32(16)) | (b3 << _U32(24))).astype(_U32)


def _vbatch_0_to_4(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    n = mat.shape[0]
    b = np.zeros(n, dtype=_U32)
    c = np.full(n, 9, dtype=_U32)
    maxlen = int(lens.max()) if n else 0
    for i in range(maxlen):
        active = lens > i
        v = mat[:, i].astype(np.int8).astype(np.int32).astype(_U32)
        nb = (b * _U32(C1) + v).astype(_U32)
        b = np.where(active, nb, b)
        c = np.where(active, c ^ nb, c)
    return _vfmix(_vmur(b, _vmur(lens.astype(_U32), c)))


def _vbatch_5_to_12(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    ln = lens.astype(_U32)
    a = ln.copy()
    b = (ln * _U32(5)).astype(_U32)
    c = np.full(mat.shape[0], 9, dtype=_U32)
    d = b.copy()
    a = (a + _vfetch32(mat, np.zeros_like(lens))).astype(_U32)
    b = (b + _vfetch32(mat, lens - 4)).astype(_U32)
    c = (c + _vfetch32(mat, (lens >> 1) & 4)).astype(_U32)
    return _vfmix(_vmur(c, _vmur(b, _vmur(a, d))))


def _vbatch_13_to_24(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    ln = lens.astype(_U32)
    a = _vfetch32(mat, (lens >> 1) - 4)
    b = _vfetch32(mat, np.full_like(lens, 4))
    c = _vfetch32(mat, lens - 8)
    d = _vfetch32(mat, lens >> 1)
    e = _vfetch32(mat, np.zeros_like(lens))
    f = _vfetch32(mat, lens - 4)
    h = (d * _U32(C1) + ln).astype(_U32)
    a = (_vror(a, 12) + f).astype(_U32)
    h = (_vmur(c, h) + a).astype(_U32)
    a = (_vror(a, 3) + c).astype(_U32)
    h = (_vmur(e, h) + a).astype(_U32)
    a = (_vror((a + f).astype(_U32), 12) + d).astype(_U32)
    h = (_vmur(b, h) + a).astype(_U32)
    return _vfmix(h)


def _vbatch_gt_24(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """All rows must share the same iteration count (len-1)//20; caller
    buckets."""
    ln = lens.astype(_U32)
    h = ln.copy()
    g = (ln * _U32(C1)).astype(_U32)
    f = g.copy()
    a0 = (_vror((_vfetch32(mat, lens - 4) * _U32(C1)).astype(_U32), 17) * _U32(C2)).astype(_U32)
    a1 = (_vror((_vfetch32(mat, lens - 8) * _U32(C1)).astype(_U32), 17) * _U32(C2)).astype(_U32)
    a2 = (_vror((_vfetch32(mat, lens - 16) * _U32(C1)).astype(_U32), 17) * _U32(C2)).astype(_U32)
    a3 = (_vror((_vfetch32(mat, lens - 12) * _U32(C1)).astype(_U32), 17) * _U32(C2)).astype(_U32)
    a4 = (_vror((_vfetch32(mat, lens - 20) * _U32(C1)).astype(_U32), 17) * _U32(C2)).astype(_U32)
    h = (_vror(h ^ a0, 19) * _U32(5) + _U32(0xE6546B64)).astype(_U32)
    h = (_vror(h ^ a2, 19) * _U32(5) + _U32(0xE6546B64)).astype(_U32)
    g = (_vror(g ^ a1, 19) * _U32(5) + _U32(0xE6546B64)).astype(_U32)
    g = (_vror(g ^ a3, 19) * _U32(5) + _U32(0xE6546B64)).astype(_U32)
    f = (f + a4).astype(_U32)
    f = (_vror(f, 19) + _U32(113)).astype(_U32)
    iters = int((int(lens[0]) - 1) // 20)
    off = np.zeros_like(lens)
    for _ in range(iters):
        a = _vfetch32(mat, off)
        b = _vfetch32(mat, off + 4)
        c = _vfetch32(mat, off + 8)
        d = _vfetch32(mat, off + 12)
        e = _vfetch32(mat, off + 16)
        h = (h + a).astype(_U32)
        g = (g + b).astype(_U32)
        f = (f + c).astype(_U32)
        h = (_vmur(d, h) + e).astype(_U32)
        g = (_vmur(c, g) + a).astype(_U32)
        f = (_vmur((b + (e * _U32(C1)).astype(_U32)).astype(_U32), f) + d).astype(_U32)
        f = (f + g).astype(_U32)
        g = (g + f).astype(_U32)
        off = off + 20
    g = (_vror(g, 11) * _U32(C1)).astype(_U32)
    g = (_vror(g, 17) * _U32(C1)).astype(_U32)
    f = (_vror(f, 11) * _U32(C1)).astype(_U32)
    f = (_vror(f, 17) * _U32(C1)).astype(_U32)
    h = _vror((h + g).astype(_U32), 19)
    h = (h * _U32(5) + _U32(0xE6546B64)).astype(_U32)
    h = (_vror(h, 17) * _U32(C1)).astype(_U32)
    h = _vror((h + f).astype(_U32), 19)
    h = (h * _U32(5) + _U32(0xE6546B64)).astype(_U32)
    h = (_vror(h, 17) * _U32(C1)).astype(_U32)
    return h


def fingerprint32_batch(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Vectorized Fingerprint32 over N byte strings.

    ``mat`` is (N, L) uint8, right-padded with at least 4 zero bytes beyond
    each row's length; ``lens`` is (N,) int.  Rows are grouped by control-flow
    bucket and each bucket is hashed in lockstep.
    """
    mat = np.asarray(mat, dtype=np.uint8)
    lens = np.asarray(lens, dtype=np.int64)
    n = mat.shape[0]
    out = np.zeros(n, dtype=_U32)
    if n == 0:
        return out
    if mat.shape[1] < int(lens.max()) + 4:
        mat = np.pad(mat, ((0, 0), (0, 4)))

    cls = np.where(lens <= 4, 0, np.where(lens <= 12, 1, np.where(lens <= 24, 2, 3)))
    for c, fn in ((0, _vbatch_0_to_4), (1, _vbatch_5_to_12), (2, _vbatch_13_to_24)):
        idx = np.nonzero(cls == c)[0]
        if idx.size:
            out[idx] = fn(mat[idx], lens[idx])
    idx3 = np.nonzero(cls == 3)[0]
    if idx3.size:
        iters = (lens[idx3] - 1) // 20
        for it in np.unique(iters):
            sub = idx3[iters == it]
            out[sub] = _vbatch_gt_24(mat[sub], lens[sub])
    return out


def pack_strings(strings: list[bytes | str]) -> tuple[np.ndarray, np.ndarray]:
    """Pack variable-length strings into the (mat, lens) form
    :func:`fingerprint32_batch` consumes."""
    bs = [s.encode("utf-8") if isinstance(s, str) else s for s in strings]
    lens = np.array([len(b) for b in bs], dtype=np.int64)
    width = (int(lens.max()) if bs else 0) + 4
    mat = np.zeros((len(bs), width), dtype=np.uint8)
    for i, b in enumerate(bs):
        mat[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return mat, lens
