"""Frontend halves of the serve tier.

``ServeClient`` is what a frontend process holds: it submits key-hash
batches to the shared ring service over any channel and resolves owner
ids to addresses through a cached per-generation server list (fetched
once per generation from ``/ring``).

``HostBisectFrontend`` is the per-process BASELINE the paired A/B prices:
the exact bisect walk the host plane does today (plain-int token list,
first token >= hash with wraparound — ``hashring._lookup_n_hash``'s n=1
fast path), rebuilt locally from the same server list, so its owner
decisions are bit-comparable to the device tier's per key and per
membership generation.

Counterpart of ``ringpop_tpu/serve/client.py``; imports no torch.
"""

from __future__ import annotations

import bisect
from typing import Optional

import numpy as np

from ringpop_tpu_torch.hashring import HashRing
from ringpop_tpu_torch.net.channel import decode_array, encode_array


class ServeClient:
    """Frontend handle on a remote ``RingService``."""

    def __init__(self, channel, peer: str, *, timeout: float = 30.0):
        self.channel = channel
        self.peer = peer
        self.timeout = timeout
        self.codec = getattr(channel, "codec", "json")
        self._servers: dict[int, list[str]] = {}

    async def lookup_hashes(self, hashes: np.ndarray, n: int = 1):
        """(owners int32[B] or int32[B, n], generation) for a uint32 hash
        batch — one request, micro-batched server-side."""
        res = await self.channel.call(
            self.peer,
            "serve",
            "/lookup",
            {"h": encode_array(hashes, self.codec, "<u4"), "n": n},
            timeout=self.timeout,
        )
        owners = decode_array(res["o"], "<i4")
        if n > 1:
            owners = owners.reshape(-1, n)
        return owners, int(res["gen"])

    async def servers_at(self, gen: int) -> list[str]:
        """Server list of a generation (cached; one ``/ring`` fetch per
        new generation)."""
        if gen not in self._servers:
            res = await self.channel.call(
                self.peer, "serve", "/ring", {"gen": gen}, timeout=self.timeout
            )
            self._servers[int(res["gen"])] = res["servers"]
        return self._servers[gen]

    async def lookup(self, hashes: np.ndarray) -> list[Optional[str]]:
        """Resolved owner addresses for a hash batch (the convenience
        wrapper; the A/B drives :meth:`lookup_hashes` directly)."""
        owners, gen = await self.lookup_hashes(hashes)
        servers = await self.servers_at(gen)
        return [servers[o] if o >= 0 else None for o in owners]


class HostBisectFrontend:
    """The per-process baseline: local bisect walk over the same ring."""

    def __init__(self, servers: list[str], replica_points: int = 100):
        self.ring = HashRing(replica_points=replica_points)
        if servers:
            self.ring.add_remove_servers(list(servers), [])
        self._tokens = self.ring._tokens_list
        self._owners = self.ring._owners_list

    def lookup_hashes(self, hashes: np.ndarray) -> np.ndarray:
        """int32[B] owner ids — the scalar bisect walk per key, the host
        plane's data-path lookup as it exists today."""
        toks, owners = self._tokens, self._owners
        t = len(toks)
        out = np.empty(hashes.shape[0], np.int32)
        if t == 0:
            out.fill(-1)
            return out
        bl = bisect.bisect_left
        for i, h in enumerate(hashes.tolist()):
            idx = bl(toks, h)
            if idx == t:
                idx = 0
            out[i] = owners[idx]
        return out
