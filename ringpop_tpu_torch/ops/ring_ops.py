"""Batched consistent-ring lookup ops in PyTorch.

Counterpart of ``ringpop_tpu/ops/ring_ops.py``: ``torch.searchsorted`` over
the sorted token array answers millions of keys per call against a
million-vnode ring (the reference's red-black tree, ``hashring/rbtree.go``,
answers one at a time).  Plain PyTorch — the JAX package lowers these
through XLA, not Pallas.

Tokens and key hashes are int64 tensors holding the uint32 value
(:func:`_as_u32` widens any 32-bit-valued input), so a hash >= 2**31 is
never compared signed against the tokens — the r13 misroute.  Owner ids are
int32.  ``torch.argsort`` is NOT stable by default; the LookupN windows pass
``stable=True`` or the first-seen owner order changes when an owner repeats
inside a window.
"""

from __future__ import annotations

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.hashing import ring_tokens as _ring_tokens

_M32 = 0xFFFFFFFF


def _as_u32(a) -> torch.Tensor:
    """Any 32-bit-valued integer tensor (or array) -> int64 holding the
    uint32 value: the two's-complement reinterpretation of int32 input, the
    value itself for uint32 / int64 input."""
    a = torch.as_tensor(a)
    return a.to(torch.int64) & _M32


def ring_composite_order(tokens, owners) -> np.ndarray:
    """Stable argsort by the canonical ``(token << 32 | owner)`` composite —
    the collision order every host and device ring shares
    (``hashring._rebuild``'s rule)."""
    comp = (
        np.asarray(tokens, np.uint64) << np.uint64(32)
    ) | np.asarray(owners, np.int64).astype(np.uint64)
    return np.argsort(comp, kind="stable")


def build_ring_tokens(
    servers: list[str], replica_points: int = 100, device: DeviceLike = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Host-side construction of the (tokens int64, owners int32) tensors
    for a server list — same hash/replica scheme as the host ring
    (``hashring.go:148-154``) — placed on ``device`` (the card by default)."""
    dev = resolve_device(device)
    toks = _ring_tokens(servers, replica_points).reshape(-1).astype(np.uint32)
    owners = np.repeat(np.arange(len(servers), dtype=np.int32), replica_points)
    order = ring_composite_order(toks, owners)
    return (
        torch.from_numpy(toks[order].astype(np.int64)).to(dev),
        torch.from_numpy(owners[order]).to(dev),
    )


def ring_lookup(tokens: torch.Tensor, owners: torch.Tensor, key_hashes) -> torch.Tensor:
    """Owner index for each key hash: first token >= hash, wrapping to 0
    (parity: ``hashring.go:279-301`` walk semantics)."""
    keys = _as_u32(key_hashes).to(tokens.device)
    idx = torch.searchsorted(_as_u32(tokens), keys, side="left")
    idx = torch.where(idx == tokens.shape[0], 0, idx)
    return owners[idx]


def _first_unique(cand: torch.Tensor, n: int, valid: bool = False):
    """First-``n``-unique owners along each row of the walk ``cand``
    int32[B, w] -> (int32[B, n] -1 padded, int32[B] unique count).

    The first occurrence of each owner comes from a STABLE argsort by owner:
    walk positions are already ascending, so the stable sort yields (owner
    asc, pos asc) and the head of each equal-owner run is the owner's first
    sighting, scattered back to its walk position.  ``valid`` drops -1
    candidates (an empty padded ring's) from the count."""
    b, w = cand.shape
    spos = torch.argsort(cand, dim=1, stable=True)
    sowner = torch.gather(cand, 1, spos)
    head = torch.cat(
        [torch.ones((b, 1), dtype=torch.bool, device=cand.device),
         sowner[:, 1:] != sowner[:, :-1]],
        dim=1,
    )
    if valid:
        head = head & (sowner >= 0)
    first_seen = torch.zeros((b, w), dtype=torch.bool, device=cand.device)
    first_seen.scatter_(1, spos, head)
    # rank among first-seen owners; everything past rank n goes to the
    # overflow slot n (several writes of the same -1), sliced away
    rank = torch.cumsum(first_seen, dim=1) - 1
    take = first_seen & (rank < n)
    slot = torch.where(take, rank, n)
    out = torch.full((b, n + 1), -1, dtype=torch.int32, device=cand.device)
    out.scatter_(1, slot, torch.where(take, cand, -1).to(torch.int32))
    return out[:, :n], first_seen.sum(dim=1).to(torch.int32)


def _lookup_n_window(tokens, owners, key_hashes, n: int, w: int):
    """One windowed scan: first-``n``-unique owners within ``w`` consecutive
    tokens from each key's start position, plus the per-key unique count
    (for the exactness rescue in :func:`ring_lookup_n`)."""
    keys = _as_u32(key_hashes).to(tokens.device)
    start = torch.searchsorted(_as_u32(tokens), keys, side="left")
    pos = torch.arange(w, device=tokens.device)
    offs = (start[:, None] + pos[None, :]) % tokens.shape[0]
    return _first_unique(owners[offs].to(torch.int32), n)


def ring_lookup_n(
    tokens: torch.Tensor, owners: torch.Tensor, key_hashes, n: int, num_servers: int
) -> torch.Tensor:
    """First ``n`` *unique* owners walking the ring upward per key — EXACT
    (parity: ``hashring/rbtree.go:262-288`` LookupNUniqueAt + wraparound).

    Returns int32[B, n] owner ids, -1 padded when fewer than ``n`` servers
    exist.  A windowed scan of ``w`` consecutive tokens, then — iff any key
    found fewer than ``min(n, num_servers)`` owners — the window doubles and
    rescans until satisfied or the whole ring is covered.  The doubling is
    decided on the host, one ``bool`` read per window."""
    t = int(tokens.shape[0])
    b = int(torch.as_tensor(key_hashes).shape[0])
    if t == 0:
        return torch.full((b, n), -1, dtype=torch.int32, device=tokens.device)
    need = min(n, num_servers)
    w = min(max(4 * n, 16), t)
    while True:
        out, found = _lookup_n_window(tokens, owners, key_hashes, n, w)
        if w >= t or bool((found >= need).all()):
            return out
        w = min(2 * w, t)


def host_lookup_n(tokens, owners, key_hashes, n: int, num_servers: int) -> np.ndarray:
    """Host-side exact N-unique-owner walk, batched over keys (parity:
    ``hashring/rbtree.go:262-288`` LookupNUniqueAt + wraparound) — numpy, the
    oracle every device LookupN flavor is pinned against.  Returns
    int32[B, n], -1 padded when fewer than ``n`` unique owners exist."""
    tokens = np.asarray(tokens).astype(np.uint32)
    owners = np.asarray(owners, dtype=np.int32)
    hashes = np.asarray(key_hashes).astype(np.uint32)
    b = int(hashes.shape[0])
    n = max(n, 0)
    out = np.full((b, n), -1, np.int32)
    t = int(tokens.shape[0])
    if t == 0 or n == 0:
        return out
    need = min(n, num_servers) if num_servers > 0 else n
    starts = np.searchsorted(tokens, hashes, side="left").astype(np.int64)
    # windowed walk with host-side doubling: per key only a w ≈ 4n window
    # is materialized, so the cost is O(B·w), independent of ring size
    remaining = np.arange(b)
    w = min(max(4 * n, 16), t)
    while remaining.size:
        offs = (starts[remaining, None] + np.arange(w)) % t
        cand = owners[offs]  # [R, w]
        final = w >= t
        unfinished = []
        for row, i in enumerate(remaining):
            seen: set[int] = set()
            k = 0
            for o in cand[row].tolist():
                if o not in seen:
                    seen.add(o)
                    if k < n:
                        out[i, k] = o
                    k += 1
                    if k >= need:
                        break
            if k < need and not final:
                out[i, :] = -1  # partial prefix: rescan at a wider window
                unfinished.append(i)
        if final:
            break
        remaining = np.asarray(unfinished, np.int64)
        w = min(2 * w, t)
    return out


# ---------------------------------------------------------------------------
# Capacity-padded device ring (the serve tier's resident state)
# ---------------------------------------------------------------------------
#
# The padded variants keep the ring at a fixed CAPACITY with a live count
# held on the device: tokens[count:] hold PAD_TOKEN (0xFFFFFFFF as int64 —
# sorts last; a real token of the same value still wins the side="left"
# search) and owners[count:] hold -1.  Updates swap values, never shapes
# (``serve.state.ring_commit``).

PAD_TOKEN = 0xFFFFFFFF


def pad_ring_arrays(tokens, owners, capacity: int):
    """Host-side: (uint32[C], int32[C], count) from exact-size arrays."""
    tokens = np.asarray(tokens).astype(np.uint32)
    owners = np.asarray(owners, dtype=np.int32)
    count = int(tokens.shape[0])
    if count > capacity:
        raise ValueError(f"ring of {count} tokens exceeds capacity {capacity}")
    pt = np.full(capacity, PAD_TOKEN, dtype=np.uint32)
    po = np.full(capacity, -1, dtype=np.int32)
    pt[:count] = tokens
    po[:count] = owners
    return pt, po, count


def _count_tensor(count, device) -> torch.Tensor:
    return torch.as_tensor(count, device=device).to(torch.int64).reshape(())


def ring_lookup_padded(
    tokens: torch.Tensor, owners: torch.Tensor, count, key_hashes
) -> torch.Tensor:
    """:func:`ring_lookup` against a capacity-padded ring.  ``count`` is the
    live-token count (a tensor or int); an empty ring answers -1."""
    keys = _as_u32(key_hashes).to(tokens.device)
    count = _count_tensor(count, tokens.device)
    idx = torch.searchsorted(_as_u32(tokens), keys, side="left")
    # past the live region (pads, or == C on a full ring): wrap to 0
    idx = torch.where(idx >= count, 0, idx)
    return torch.where(count > 0, owners[idx].to(torch.int32), -1)


def _lookup_n_window_padded(tokens, owners, count, key_hashes, n: int, w: int):
    """The windowed scan of :func:`_lookup_n_window` with a live count: walk
    positions advance mod ``count`` (not capacity), so wrapped revisits are
    literal duplicates the uniqueness machinery drops."""
    count = _count_tensor(count, tokens.device)
    keys = _as_u32(key_hashes).to(tokens.device)
    cnt = torch.clamp(count, min=1)
    start = torch.searchsorted(_as_u32(tokens), keys, side="left")
    start = torch.where(start >= count, 0, start)
    pos = torch.arange(w, device=tokens.device)
    offs = (start[:, None] + pos[None, :]) % cnt
    cand = torch.where(count > 0, owners[offs].to(torch.int32), -1)
    return _first_unique(cand, n, valid=True)


def ring_lookup_n_padded(
    tokens: torch.Tensor,
    owners: torch.Tensor,
    count,
    num_servers,
    key_hashes,
    n: int,
) -> torch.Tensor:
    """:func:`ring_lookup_n` against a capacity-padded ring — the same
    window-doubling rescue and exactness contract, shape-stable in the
    ring: ``count`` / ``num_servers`` may live on the device."""
    c = int(tokens.shape[0])
    b = int(torch.as_tensor(key_hashes).shape[0])
    if c == 0 or n <= 0:
        return torch.full((b, max(n, 0)), -1, dtype=torch.int32, device=tokens.device)
    need = torch.clamp(_count_tensor(num_servers, tokens.device), max=n)
    w = min(max(4 * n, 16), c)
    while True:
        out, found = _lookup_n_window_padded(tokens, owners, count, key_hashes, n, w)
        # w >= capacity >= count covers the whole live ring: exact
        if w >= c or bool((found >= need).all()):
            return out
        w = min(2 * w, c)
