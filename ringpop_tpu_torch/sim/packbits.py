"""Bit-packed boolean planes for the O(N·K) sim engines.

Counterpart of ``ringpop_tpu/sim/packbits.py``.  The per-(node, rumor)
booleans of the engines are packed 32 slots to a word along the rumor axis:
slot ``j`` lives in word ``j >> 5``, bit ``j & 31`` (LSB-first), and the
tail bits past ``k`` in the last word are always zero.

Representation: a packed plane is an **int32 tensor holding the uint32 bit
pattern** (a JAX uint32 leaf crosses as ``np.asarray(x).view(np.int32)``
and comes back with ``.view(np.uint32)``).  Bitwise ops and popcount do not
care about the sign; a right shift does, since int32 ``>>`` is arithmetic,
so every shift of a word here is masked (``(p >> j) & 1``) or goes through
the word's bytes (``uint8`` shifts are logical).  Scalar and lane
arithmetic — :func:`mix32`, :func:`flat_index_u32` and the counter stream
built on them — is int64 holding uint32, masked with ``& 0xFFFFFFFF`` after
each product: on torch's CPU build ``torch.uint32`` has no ``>>``.  An int64
product of two such values can wrap past 2**63; the wrap keeps the low 32
bits, which is all the mask keeps.

:func:`popcount_rows`, :func:`or_reduce_rows` and :func:`and_reduce_rows`
follow their input's device: a CPU tensor takes the plain PyTorch version
in this module, a CUDA tensor the hand-written Hopper kernel
(``ops/packbits_kernel.py``, ``csrc/packbits.cu``) or an error — never a
fallback.  Torch has no popcount and no bitwise OR/AND reduction, so the
plain version of each is a chain of several launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from ringpop_tpu_torch.ops import packbits_kernel

WORD = 32
M32 = 0xFFFF_FFFF

# popcount of every byte value: the plain popcount reads a plane's bytes
_POPCOUNT8 = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.uint8)

# node-axis block count of the plain halving tree (the JAX package's
# ``_REDUCE_BLOCKS``, kept so the plain version is the same tree)
_REDUCE_BLOCKS = 16


def n_words(k: int) -> int:
    """Words needed for k slots."""
    return (k + WORD - 1) // WORD


def as_u32(x, device=None) -> torch.Tensor:
    """``x`` (a tensor or a Python int) as int64 holding its uint32 value —
    the two's-complement wrap of ``.astype(uint32)``."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def as_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 -> int32 holding the same bit pattern (exact:
    no out-of-range narrowing cast)."""
    return ((v ^ 0x8000_0000) - 0x8000_0000).to(torch.int32)


def mix32(x) -> torch.Tensor:
    """murmur3 fmix32 (full avalanche), on int64 holding uint32; any integer
    input is taken mod 2**32 first.  Returns int64 in [0, 2**32)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = (x * 0x85EB_CA6B) & M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2_AE35) & M32
    return x ^ (x >> 16)


def flat_index_u32(row, ncols: int, col) -> torch.Tensor:
    """Global flat index ``row * ncols + col`` in wrapping uint32
    arithmetic, as int64 in [0, 2**32): the digest/mixing-lane spelling,
    where the value is consumed mod 2**32 by design."""
    device = row.device if isinstance(row, torch.Tensor) else (
        col.device if isinstance(col, torch.Tensor) else None)
    return (as_u32(row, device) * (ncols & M32) + as_u32(col, device)) & M32


def pack_bool(x: torch.Tensor) -> torch.Tensor:
    """bool[..., K] -> int32[..., W] (LSB-first within each word; tail bits
    zero).  Packs each run of 8 slots into a byte and reads every 4 bytes
    as one little-endian word."""
    k = x.shape[-1]
    w = n_words(k)
    lead = x.shape[:-1]
    pad = w * WORD - k
    if pad:
        x = torch.cat([x, x.new_zeros(lead + (pad,))], dim=-1)
    shifts = torch.arange(8, dtype=torch.uint8, device=x.device)
    bits = x.reshape(lead + (w * 4, 8)).to(torch.uint8) << shifts
    return bits.sum(dim=-1, dtype=torch.uint8).view(torch.int32)


def unpack_bits(p: torch.Tensor, k: int) -> torch.Tensor:
    """int32[..., W] -> bool[..., K]."""
    w = p.shape[-1]
    byts = p.contiguous().view(torch.uint8)  # [..., 4W], little-endian
    shifts = torch.arange(8, dtype=torch.uint8, device=p.device)
    bits = (byts[..., None] >> shifts) & 1  # uint8 >> is logical
    return bits.reshape(p.shape[:-1] + (w * WORD,))[..., :k].to(torch.bool)


def bit_column(p: torch.Tensor, j) -> torch.Tensor:
    """Slot bits of a packed plane, ``j`` in [0, 32·W).  Scalar ``j`` on
    p[..., W] -> bool[...] (one slot's column); ``j`` with ``j.shape ==
    p.shape[:-1]`` -> bool[...] (one slot per row)."""
    j = torch.as_tensor(j, device=p.device).to(torch.int64)
    if j.ndim == 0:
        word = p.index_select(-1, (j >> 5).reshape(1)).squeeze(-1)
    else:
        word = torch.gather(p, -1, (j >> 5)[..., None])[..., 0]
    return ((word >> (j & 31)) & 1).to(torch.bool)


def row_mask(rows: torch.Tensor) -> torch.Tensor:
    """bool[N] -> int32[N, 1]: an all-ones word where True (the broadcast
    gate for packed planes)."""
    return (-rows.to(torch.int32))[..., None]


def nonzero_rows(p: torch.Tensor) -> torch.Tensor:
    """[N, ...] -> bool[N]: rows carrying any nonzero element (integer
    planes; the test is value-level)."""
    return (p.reshape(p.shape[0], -1) != 0).any(dim=-1)


def popcount_rows_plain(p: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`popcount_rows`: a byte-table lookup."""
    table = _POPCOUNT8.to(p.device)
    byts = p.contiguous().view(torch.uint8).to(torch.int64)  # [N, 4W]
    return table[byts].sum(dim=-1, dtype=torch.int32)


def popcount_rows(p: torch.Tensor) -> torch.Tensor:
    """int32[N, W] -> int32[N]: per-row set-bit count (at most 32·W, so
    int32 never wraps).  The kernel on a CUDA tensor."""
    if p.device.type == "cpu":
        return popcount_rows_plain(p)
    return packbits_kernel.popcount_rows_cuda(p)


def block_count(n: int, b: int) -> int:
    """Largest power of two <= ``b`` that divides ``n``."""
    while b > 1 and n % b:
        b //= 2
    return b


def _halving_tree(p: torch.Tensor, op, identity: int, dim: int) -> torch.Tensor:
    """Halving tree of ``op`` along ``dim`` (padded with ``identity`` to a
    power of two): the JAX package's tree, one elementwise combine per
    level."""
    n = p.shape[dim]
    pow2 = 1 << max(n - 1, 1).bit_length()
    if pow2 == 2 * n:
        pow2 = n  # n was already a power of two
    if pow2 != n:
        shape = list(p.shape)
        shape[dim] = pow2 - n
        p = torch.cat([p, p.new_full(shape, identity)], dim=dim)
    while pow2 > 1:
        pow2 //= 2
        p = op(p.narrow(dim, 0, pow2), p.narrow(dim, pow2, pow2))
    return p.squeeze(dim)


def _tree_reduce_rows(p: torch.Tensor, op, identity: int) -> torch.Tensor:
    """Bitwise reduce over the node axis: a halving tree within each of
    ``block_count(n, 16)`` contiguous blocks, then over the blocks.  Any
    order gives the same bits: OR and AND reassociate exactly."""
    n = p.shape[0]
    g = block_count(n, _REDUCE_BLOCKS)
    if g > 1 and n > g:
        p = _halving_tree(p.reshape((g, n // g) + p.shape[1:]), op, identity, dim=1)
    return _halving_tree(p, op, identity, dim=0)


def or_reduce_rows_plain(p: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`or_reduce_rows`."""
    if rows is not None:
        p = p & row_mask(rows)
    return _tree_reduce_rows(p, torch.bitwise_or, 0)


def and_reduce_rows_plain(p: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`and_reduce_rows`."""
    if rows is not None:
        p = p | row_mask(~rows)
    return _tree_reduce_rows(p, torch.bitwise_and, -1)


def or_reduce_rows(p: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32[N, W] -> int32[W]: bitwise OR over the node axis, of the rows
    where ``rows`` (bool[N]) is True when it is given — equal to
    ``or_reduce_rows(p & row_mask(rows))``, without the masked copy on the
    card.  The kernel on a CUDA tensor."""
    if p.device.type == "cpu":
        return or_reduce_rows_plain(p, rows)
    return packbits_kernel.reduce_rows_cuda(p, "or", rows)


def and_reduce_rows(p: torch.Tensor, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32[N, W] -> int32[W]: bitwise AND over the node axis, of the rows
    where ``rows`` is True when it is given — equal to
    ``and_reduce_rows(p | row_mask(~rows))``.  The kernel on a CUDA tensor."""
    if p.device.type == "cpu":
        return and_reduce_rows_plain(p, rows)
    return packbits_kernel.reduce_rows_cuda(p, "and", rows)


def _scatter_index(idx: torch.Tensor, size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(index, in range) of a JAX scatter index: a negative index counts
    from the end, and what is still outside [0, size) is dropped."""
    idx = torch.where(idx < 0, idx + size, idx)
    ok = (idx >= 0) & (idx < size)
    return torch.where(ok, idx, 0), ok


def set_bit(p: torch.Tensor, rows, slots, on) -> torch.Tensor:
    """OR bits (rows[i], slots[i]) into packed plane ``p`` where ``on[i]``;
    an index out of range is dropped (after a negative one counts from the
    end, as JAX's scatter does).

    An add-scatter on a zero plane, then ORed in: (row, slot) pairs must be
    distinct where ``on``, because two adds of the same bit would carry
    into the next slot instead of ORing (the JAX contract)."""
    n, w = p.shape
    rows = torch.as_tensor(rows, device=p.device).to(torch.int64)
    slots = torch.as_tensor(slots, device=p.device).to(torch.int64)
    on = torch.as_tensor(on, device=p.device)
    rows, slots, on = torch.broadcast_tensors(rows, slots, on)
    r, r_ok = _scatter_index(rows, n)
    c, c_ok = _scatter_index(slots >> 5, w)  # arithmetic >>: a negative slot stays negative
    keep = on & r_ok & c_ok
    vals = torch.where(keep, torch.ones_like(slots) << (slots & 31), 0)
    upd = torch.zeros(n * w, dtype=torch.int64, device=p.device)
    upd.index_add_(0, (r * w + c).reshape(-1), vals.reshape(-1))
    return p | as_i32(upd & M32).reshape(n, w)


def set_bit_per_row(p: torch.Tensor, slots: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """Row ``i`` ORs in bit ``slots[i]`` where ``on[i]``: an elementwise
    one-hot against the word index (callers clamp the slots)."""
    w = p.shape[1]
    slots = torch.as_tensor(slots, device=p.device).to(torch.int64)
    hit = (slots[:, None] >> 5) == torch.arange(w, device=p.device)[None, :]
    bit = as_i32(torch.ones_like(slots) << (slots & 31))[:, None]
    return p | torch.where(hit & on[:, None], bit, 0)


def check_rumor_shardable(k: int, rumor_shards: int) -> None:
    """Validate that ``k`` rumor slots can shard over a ``rumor_shards``-way
    rumor axis: the packed planes shard 32-slot words and the unpacked
    planes slots, so ``k`` must be a multiple of ``32 * rumor_shards``."""
    if rumor_shards > 1 and k % (WORD * rumor_shards):
        raise ValueError(
            f"k={k} cannot shard over a {rumor_shards}-way rumor axis: the "
            f"bit-packed planes shard 32-slot words, so k must be a "
            f"multiple of 32 * rumor_shards (= {WORD * rumor_shards}); "
            f"n_words(k)={n_words(k)} words / slot-alignment would not "
            f"divide evenly"
        )


# -- cross-rank forms: each node rank reduces its own rows, the ranks combine --
#
# On a (P, R) mesh a rank's block is [rows, W/R] words: the row reduces
# combine over the node axis only (each word block is reduced by its own
# column of ranks), so their words are this rank's word block; a caller
# that needs the whole [W] row gathers it over the rumor axis
# (``Mesh.gather_cols``).  The popcounts sum over both axes.


def or_reduce_rows_across(p: torch.Tensor, rows: Optional[torch.Tensor], mesh, partials: bool = False):
    """:func:`or_reduce_rows` of a node-sharded plane, ``p`` and ``rows``
    being this rank's block: S1 over the block, then the node axis' words
    ORed (``Mesh.or_words``); with ``mesh`` None, the plane is whole and S1
    alone answers.  With ``partials``, also every node rank's own words
    [P, W]."""
    words = or_reduce_rows(p, rows)
    if mesh is None:
        return (words, words[None]) if partials else words
    return mesh.or_words(words, partials)


def and_reduce_rows_across(p: torch.Tensor, rows: Optional[torch.Tensor], mesh) -> torch.Tensor:
    """:func:`and_reduce_rows` of a node-sharded plane (this rank's block):
    S1 over the block, then the node axis' words ANDed; S1 alone with
    ``mesh`` None."""
    words = and_reduce_rows(p, rows)
    return words if mesh is None else mesh.and_words(words)


def popcount_rows_across(p: torch.Tensor, mesh) -> torch.Tensor:
    """:func:`popcount_rows` of a node-sharded plane, gathered: int32[N],
    S2 over this rank's block, the rumor axis' counts of each row added
    (exact integers), then every node rank's rows in order; S2 alone with
    ``mesh`` None."""
    counts = popcount_rows(p)
    if mesh is None:
        return counts
    if mesh.shape.get("rumor", 1) > 1:
        counts = mesh.all_gather(counts, "rumor").sum(dim=0, dtype=torch.int32)
    return mesh.gather_rows(counts)
