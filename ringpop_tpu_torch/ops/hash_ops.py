"""FarmHash Fingerprint32 in plain PyTorch + the fused keyed ring lookup.

Counterpart of ``ringpop_tpu/ops/hash_ops.py``.  :func:`fingerprint32_device`
is the plain PyTorch version of the Fingerprint32 kernel
(``ops/hash_kernel.py``, ``csrc/fingerprint32.cu``): the CPU path of the
port, and what ``chip_smoke.py`` holds the kernel against on the card.
When a card is present nothing on the main path calls it.

Arithmetic: hashes are int64 tensors holding the uint32 value.  uint32
``+``, ``>>`` and ``%`` are not implemented for CPU tensors, and int32
``>>`` sign-extends, so every value stays in [0, 2**32) as int64 and each
multiply and add is masked with ``& 0xFFFFFFFF``.  An int64 product of two
such values can wrap past 2**63; the wrap keeps the low 32 bits, which is
all the mask keeps.

As in the JAX version, the four length classes are evaluated for every row
and selected with ``torch.where`` (branchless); the >24-byte mixing loop
runs ``(W-1)//20`` iterations at STATIC byte offsets with per-row activity
masks, and only the tail fetches use per-row offsets — clamped to
``[0, W-4]``, since ``torch.gather`` raises on an index out of range where
``jnp.take_along_axis`` forgives it.
"""

from __future__ import annotations

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device

M32 = 0xFFFFFFFF
C1 = 0xCC9E2D51
C2 = 0x1B873593
MIX5 = 5
MIXC = 0xE6546B64


def _ror(v: torch.Tensor, s: int) -> torch.Tensor:
    """Logical 32-bit rotate right of int64-held uint32 values."""
    return ((v >> s) | (v << (32 - s))) & M32


def _fmix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def _mur(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    a = (a * C1) & M32
    a = _ror(a, 17)
    a = (a * C2) & M32
    h = h ^ a
    h = _ror(h, 19)
    return (h * MIX5 + MIXC) & M32


def _word(b: torch.Tensor) -> torch.Tensor:
    """Little-endian u32 from four byte columns [..., 4] (int64)."""
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _fetch32_at(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Little-endian u32 at per-row byte offsets, clamped to [0, W-4]."""
    idx = idx.clamp(0, mat.shape[1] - 4)
    cols = idx[:, None] + torch.arange(4, device=mat.device)[None, :]
    return _word(torch.gather(mat, 1, cols).to(torch.int64))


def _fetch32_col(mat: torch.Tensor, off: int) -> torch.Tensor:
    """Little-endian u32 at one static byte offset (column slice)."""
    return _word(mat[:, off : off + 4].to(torch.int64))


def _hash_0_4(mat, lens):
    b = torch.zeros(mat.shape[0], dtype=torch.int64, device=mat.device)
    c = torch.full_like(b, 9)
    for i in range(min(4, mat.shape[1])):
        active = lens > i
        v = mat[:, i].to(torch.int64)
        v = (v - ((v >> 7) << 8)) & M32  # signed char, as uint32
        nb = (b * C1 + v) & M32
        b = torch.where(active, nb, b)
        c = torch.where(active, c ^ nb, c)
    return _fmix(_mur(b, _mur(lens & M32, c)))


def _hash_5_12(mat, lens):
    ln = lens & M32
    a = (ln + _fetch32_at(mat, torch.zeros_like(lens))) & M32
    b = (ln * 5 + _fetch32_at(mat, lens - 4)) & M32
    c = (9 + _fetch32_at(mat, (lens >> 1) & 4)) & M32
    d = (ln * 5) & M32
    return _fmix(_mur(c, _mur(b, _mur(a, d))))


def _hash_13_24(mat, lens):
    ln = lens & M32
    a = _fetch32_at(mat, (lens >> 1) - 4)
    b = _fetch32_at(mat, torch.full_like(lens, 4))
    c = _fetch32_at(mat, lens - 8)
    d = _fetch32_at(mat, lens >> 1)
    e = _fetch32_at(mat, torch.zeros_like(lens))
    f = _fetch32_at(mat, lens - 4)
    h = (d * C1 + ln) & M32
    a = (_ror(a, 12) + f) & M32
    h = (_mur(c, h) + a) & M32
    a = (_ror(a, 3) + c) & M32
    h = (_mur(e, h) + a) & M32
    a = (_ror((a + f) & M32, 12) + d) & M32
    h = (_mur(b, h) + a) & M32
    return _fmix(h)


def _tail_words(mat, lens):
    """The five rotated tail constants of the >24 path (dynamic fetches)."""

    def rot(off):
        return (_ror((_fetch32_at(mat, lens - off) * C1) & M32, 17) * C2) & M32

    return rot(4), rot(8), rot(16), rot(12), rot(20)


def _hash_gt24(mat, lens, max_iters: int):
    ln = lens & M32
    a0, a1, a2, a3, a4 = _tail_words(mat, lens)
    h = ln
    g = (ln * C1) & M32
    f = g
    h = (_ror(h ^ a0, 19) * MIX5 + MIXC) & M32
    h = (_ror(h ^ a2, 19) * MIX5 + MIXC) & M32
    g = (_ror(g ^ a1, 19) * MIX5 + MIXC) & M32
    g = (_ror(g ^ a3, 19) * MIX5 + MIXC) & M32
    f = (_ror((f + a4) & M32, 19) + 113) & M32

    iters = (lens - 1).div(20, rounding_mode="floor")
    for t in range(max_iters):
        off = 20 * t
        if off + 20 > mat.shape[1]:
            break
        active = iters > t
        a = _fetch32_col(mat, off)
        b = _fetch32_col(mat, off + 4)
        c = _fetch32_col(mat, off + 8)
        d = _fetch32_col(mat, off + 12)
        e = _fetch32_col(mat, off + 16)
        nh = (_mur(d, (h + a) & M32) + e) & M32
        ng = (_mur(c, (g + b) & M32) + a) & M32
        nf = (_mur((b + e * C1) & M32, (f + c) & M32) + d) & M32
        nf = (nf + ng) & M32
        ng = (ng + nf) & M32
        h = torch.where(active, nh, h)
        g = torch.where(active, ng, g)
        f = torch.where(active, nf, f)

    g = (_ror(g, 11) * C1) & M32
    g = (_ror(g, 17) * C1) & M32
    f = (_ror(f, 11) * C1) & M32
    f = (_ror(f, 17) * C1) & M32
    h = (_ror((h + g) & M32, 19) * MIX5 + MIXC) & M32
    h = (_ror(h, 17) * C1) & M32
    h = (_ror((h + f) & M32, 19) * MIX5 + MIXC) & M32
    h = (_ror(h, 17) * C1) & M32
    return h


def check_key_matrix(mat: torch.Tensor, lens: torch.Tensor) -> None:
    """Raise ValueError unless ``mat`` is uint8[B, W >= 4] and ``lens`` an
    integer [B] on the same device — the contract of every Fingerprint32
    path (``pack_strings`` gives W = max_len + 4)."""
    if mat.dtype != torch.uint8 or mat.dim() != 2:
        raise ValueError(f"key matrix must be uint8[B, W], got {mat.dtype}{list(mat.shape)}")
    if mat.shape[1] < 4:
        raise ValueError(f"key matrix width {mat.shape[1]} < 4")
    if lens.dim() != 1 or lens.shape[0] != mat.shape[0]:
        raise ValueError(f"lens shape {list(lens.shape)} does not match B={mat.shape[0]}")
    if lens.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"lens must be int32 or int64, got {lens.dtype}")
    if lens.device != mat.device:
        raise ValueError(f"mat on {mat.device} but lens on {lens.device}")


def upload_keys(mat, lens, device: DeviceLike = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Place a packed key batch (``hashing.pack_strings``' uint8[B, W] matrix
    and lengths) on ``device`` — the card by default — as (uint8[B, W],
    int32[B]) tensors, the layout the Fingerprint32 kernel reads."""
    dev = resolve_device(device)
    mat = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.uint8)).to(dev)
    lens = torch.from_numpy(np.ascontiguousarray(lens, dtype=np.int32)).to(dev)
    check_key_matrix(mat, lens)
    return mat, lens


def fingerprint32_device(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Bit-exact FarmHash Fingerprint32 of B byte strings, plain PyTorch.

    ``mat`` uint8[B, W] right-padded with >= 4 zero bytes past each row's
    length; ``lens`` int32/int64[B].  Returns int64[B] holding the uint32
    hash, on ``mat``'s device."""
    check_key_matrix(mat, lens)
    lens = lens.to(torch.int64)
    max_iters = max((mat.shape[1] - 1) // 20, 0)
    h04 = _hash_0_4(mat, lens)
    h512 = _hash_5_12(mat, lens)
    h1324 = _hash_13_24(mat, lens)
    hbig = _hash_gt24(mat, lens, max_iters)
    return torch.where(
        lens <= 4,
        h04,
        torch.where(lens <= 12, h512, torch.where(lens <= 24, h1324, hbig)),
    )


def keyed_owner_lookup(tokens, owners, mat, lens) -> torch.Tensor:
    """The full keyed data path: Fingerprint32 each key (the CUDA kernel for
    tensors on the card, the plain version for CPU tensors), then the ring
    ownership search — int32[B] owner indices."""
    from ringpop_tpu_torch.ops.hash_kernel import fingerprint32
    from ringpop_tpu_torch.ops.ring_ops import ring_lookup

    return ring_lookup(tokens, owners, fingerprint32(mat, lens))
