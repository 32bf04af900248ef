"""Hashing front-end: FarmHash Fingerprint32 on the host (numpy only).

Counterpart of ``ringpop_tpu/hashing/__init__.py`` without the native C++
core: every call goes to the numpy copy in :mod:`.farm`, which is bit-equal
to the reference (``hashring/hashring.go:107``, ``swim/memberlist.go:86``).
These are the host halves of the keyed path — ring tokens and oracles; the
per-key hash of a lookup batch runs on the card (``ops/hash_kernel.py``) —
and the SWIM memberlist's checksum.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from ringpop_tpu_torch.hashing import farm as _farm
from ringpop_tpu_torch.hashing.farm import fingerprint32_batch, pack_strings  # re-export


def fingerprint32(data: bytes | str) -> int:
    """FarmHash Fingerprint32 of ``data`` (farmhashmk::Hash32)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    return _farm.fingerprint32(data)


def fingerprint32_many(strings: Iterable[str | bytes]) -> np.ndarray:
    """Batch Fingerprint32 -> uint32[n]."""
    strings = list(strings)
    if not strings:
        return np.empty(0, dtype=np.uint32)
    mat, lens = pack_strings(strings)
    return fingerprint32_batch(mat, lens).astype(np.uint32)


def membership_checksum(entries: Sequence[str]) -> int:
    """farm32 over sorted entries joined with trailing ';' — the membership
    checksum canonical form (parity: ``swim/memberlist.go:106-128``), built
    in Python and hashed by the numpy farm copy."""
    return fingerprint32("".join(s + ";" for s in sorted(entries)))


def ring_lookup_n_batch(
    tokens: np.ndarray,
    owners: np.ndarray,
    n_servers: int,
    hashes: np.ndarray,
    nwant: int,
) -> np.ndarray:
    """Exact batched N-owner ring walk -> int32[nkeys, nwant] server indices,
    -1-padded (parity: ``hashring.go:271-301``); the same walk per key."""
    tokens32 = np.asarray(tokens, dtype=np.uint32)
    owners32 = np.asarray(owners, dtype=np.uint32)
    hashes32 = np.asarray(hashes, dtype=np.uint32)
    nwant = max(nwant, 0)
    out = np.full((hashes32.shape[0], nwant), -1, dtype=np.int32)
    t = tokens32.shape[0]
    if t == 0 or n_servers == 0 or nwant == 0:
        return out
    want = min(nwant, n_servers)
    starts = np.searchsorted(tokens32, hashes32, side="left") % t
    for k, start in enumerate(starts):
        seen: set[int] = set()
        for i in range(t):
            owner = int(owners32[(start + i) % t])
            if owner not in seen:
                seen.add(owner)
                out[k, len(seen) - 1] = owner
                if len(seen) == want:
                    break
    return out


def ring_tokens(servers: Sequence[str], replica_points: int) -> np.ndarray:
    """uint32[n_servers, replica_points] of farm32(addr + str(i)) — the
    hashring vnode tokens (parity: ``hashring.go:148-154``)."""
    flat = fingerprint32_many([f"{s}{i}" for s in servers for i in range(replica_points)])
    return flat.reshape(len(servers), replica_points)


__all__ = [
    "fingerprint32",
    "fingerprint32_batch",
    "fingerprint32_many",
    "membership_checksum",
    "pack_strings",
    "ring_lookup_n_batch",
    "ring_tokens",
]
