"""Consistent hash ring as a sorted token array (host side, numpy).

Parity: reference ``hashring/`` (``hashring.go`` + the red-black tree
``rbtree.go``).  Same semantics — ``replica_points`` virtual nodes per server
at ``farm32(addr + str(i))`` (``hashring.go:148-154``), lookup = first unique
owners at token >= ``farm32(key)`` with wraparound (``hashring.go:279-301``,
``rbtree.go:262-288``), checksum = farm32 over the sorted ``;``-joined server
list (``hashring.go:102-120``) — with the rbtree replaced by a sorted uint64
token array + parallel owner-index array.

A copy of ``ringpop_tpu/hashring`` for the PyTorch package, which imports
nothing of the JAX package.  It differs in two ways that change no bit:
tokens come from the numpy farm copy (there is no native core here), and
``add_remove_servers`` hashes all added servers' vnodes in one batch.
Membership changes maintain the sorted arrays INCREMENTALLY
(:meth:`HashRing._apply_incremental`); ``_rebuild`` is the from-scratch
oracle it is pinned bit-identical to.

Token collisions between (server, replica) pairs are resolved by (token,
server) order, deterministically.
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Iterable, Optional

import numpy as np

from ringpop_tpu_torch.events import EventEmitter, RingChangedEvent, RingChecksumEvent
from ringpop_tpu_torch.hashing import (
    fingerprint32,
    fingerprint32_many,
    ring_lookup_n_batch,
    ring_tokens,
)


class HashRing:
    """Sorted-token-array consistent hash ring."""

    def __init__(self, hashfunc: Optional[Callable] = None, replica_points: int = 100):
        self.hashfunc = hashfunc or fingerprint32
        self.replica_points = replica_points
        self._lock = threading.RLock()
        self._server_tokens: dict[str, np.ndarray] = {}  # addr -> uint32[replica_points]
        # raw uint32 token values (uint64 dtype), sorted by the composite
        # (token << 32 | server_id) so equal tokens order by server id
        self._tokens = np.empty(0, dtype=np.uint64)
        self._owners = np.empty(0, dtype=np.int64)
        self._tokens32 = np.empty(0, dtype=np.uint32)
        self._owners32 = np.empty(0, dtype=np.uint32)
        self._tokens_list: list[int] = []
        self._owners_list: list[int] = []
        self._server_list: list[str] = []  # index -> addr for _owners
        self._checksum = 0
        self.emitter = EventEmitter()
        self._compute_checksum()

    # -- events -------------------------------------------------------------

    def register_listener(self, listener) -> None:
        self.emitter.register_listener(listener)

    def _emit(self, event) -> None:
        self.emitter.emit(event)

    # -- construction -------------------------------------------------------

    def _tokens_for(self, server: str) -> np.ndarray:
        toks = self._server_tokens.get(server)
        if toks is None:
            if self.hashfunc is fingerprint32:
                toks = ring_tokens([server], self.replica_points)[0].astype(np.uint64)
            else:
                # mask to 32 bits — the ring's token space (the same mask
                # _hash_keys applies to key hashes)
                toks = np.array(
                    [
                        self.hashfunc(f"{server}{i}") & 0xFFFFFFFF
                        for i in range(self.replica_points)
                    ],
                    dtype=np.uint64,
                )
            self._server_tokens[server] = toks
        return toks

    def _prefetch_tokens(self, servers: list[str]) -> None:
        """Hash the vnodes of every new server in ``servers`` in one numpy
        batch (the default farm32 only) — the same values ``_tokens_for``
        would compute one server at a time."""
        if self.hashfunc is not fingerprint32:
            return
        new = [s for s in dict.fromkeys(servers) if s not in self._server_tokens]
        if new:
            toks = ring_tokens(new, self.replica_points).astype(np.uint64)
            for s, row in zip(new, toks):
                self._server_tokens[s] = row

    def _rebuild(self) -> None:
        """Rebuild the sorted token/owner arrays from the server set — the
        from-scratch argsort, kept as the INDEPENDENT oracle the
        incremental path is pinned bit-identical to (no production call
        sites)."""
        servers = sorted(self._server_tokens)
        self._server_list = servers
        if not servers:
            self._tokens = np.empty(0, dtype=np.uint64)
            self._owners = np.empty(0, dtype=np.int64)
            self._refresh_caches()
            return
        toks = np.concatenate([self._server_tokens[s] for s in servers])
        owners = np.repeat(np.arange(len(servers), dtype=np.int64), self.replica_points)
        # composite sort key (token, server-id) for deterministic collision order
        composite = (toks.astype(np.uint64) << np.uint64(32)) | owners.astype(np.uint64)
        order = np.argsort(composite, kind="stable")
        self._tokens = toks[order]
        self._owners = owners[order]
        self._refresh_caches()

    def _refresh_caches(self) -> None:
        # uint32 views cached once per mutation for the batched walks, plus
        # plain-int lists for the bisect single-key fast path
        self._tokens32 = np.ascontiguousarray(self._tokens, dtype=np.uint32)
        self._owners32 = np.ascontiguousarray(self._owners, dtype=np.uint32)
        self._tokens_list = self._tokens.tolist()
        self._owners_list = self._owners.tolist()

    def _apply_incremental(self, added: list[str], removed: list[str]) -> None:
        """Update the sorted token/owner arrays for one batch of membership
        changes, without the global re-sort:

        1. renumber surviving owner ids through an old→new lookup table
           (STRICTLY MONOTONE over survivors — both server lists are
           sorted — so the masked survivors stay in composite (token,
           owner) order);
        2. mask out removed servers' rows;
        3. merge-insert the added servers' pre-sorted token blocks at their
           ``searchsorted`` positions.

        Bit-identical to :meth:`_rebuild` by construction."""
        # a server in BOTH lists of one batch is a net no-op: it is no
        # longer in _server_tokens, so it must not reach the merge-insert
        added = [s for s in added if s in self._server_tokens]
        old_servers = self._server_list
        new_servers = sorted(self._server_tokens)
        new_index = {s: i for i, s in enumerate(new_servers)}
        if old_servers:
            lut = np.array(
                [new_index.get(s, -1) for s in old_servers], dtype=np.int64
            )
            mapped = lut[self._owners]
            keep = mapped >= 0
            kept_toks = self._tokens[keep]
            kept_owners = mapped[keep]
        else:
            kept_toks = np.empty(0, dtype=np.uint64)
            kept_owners = np.empty(0, dtype=np.int64)
        if added:
            a_srv = sorted(added)
            a_toks = np.concatenate([self._server_tokens[s] for s in a_srv])
            a_owners = np.repeat(
                np.array([new_index[s] for s in a_srv], dtype=np.int64),
                self.replica_points,
            )
            a_comp = (a_toks << np.uint64(32)) | a_owners.astype(np.uint64)
            a_order = np.argsort(a_comp, kind="stable")
            a_toks, a_owners, a_comp = a_toks[a_order], a_owners[a_order], a_comp[a_order]
            kept_comp = (kept_toks << np.uint64(32)) | kept_owners.astype(np.uint64)
            pos = np.searchsorted(kept_comp, a_comp, side="left")
            total = kept_toks.size + a_toks.size
            out_t = np.empty(total, dtype=np.uint64)
            out_o = np.empty(total, dtype=np.int64)
            a_target = pos + np.arange(a_toks.size)
            mask = np.ones(total, dtype=bool)
            mask[a_target] = False
            out_t[a_target] = a_toks
            out_o[a_target] = a_owners
            out_t[mask] = kept_toks
            out_o[mask] = kept_owners
        else:
            out_t, out_o = kept_toks, kept_owners
        self._server_list = new_servers
        self._tokens = out_t
        self._owners = out_o
        self._refresh_caches()

    def _hash_keys(self, keys: list[str]) -> np.ndarray:
        """uint32 hashes of ``keys`` under this ring's hash function."""
        if self.hashfunc is fingerprint32:
            return fingerprint32_many(keys)
        return np.array(
            [self.hashfunc(k) & 0xFFFFFFFF for k in keys], dtype=np.uint32
        )

    def _compute_checksum(self) -> None:
        old = self._checksum
        joined = ";".join(sorted(self._server_tokens))
        self._checksum = fingerprint32(joined.encode("utf-8"))
        self._emit(RingChecksumEvent(old_checksum=old, new_checksum=self._checksum))

    # -- mutation (parity: hashring.go:122-223) -----------------------------

    def add_server(self, address: str) -> bool:
        return self.add_remove_servers([address], [])

    def remove_server(self, address: str) -> bool:
        return self.add_remove_servers([], [address])

    def add_remove_servers(self, add: Iterable[str], remove: Iterable[str]) -> bool:
        """Batch add/remove; emits one RingChangedEvent
        (parity: ``hashring.go:192-223`` AddRemoveServers)."""
        with self._lock:
            add = list(add or [])
            known = set(self._server_tokens)
            self._prefetch_tokens(add)
            added, removed = [], []
            for a in add:
                if a not in known:
                    self._tokens_for(a)
                    known.add(a)
                    added.append(a)
            for r in remove or []:
                if r in self._server_tokens:
                    del self._server_tokens[r]
                    removed.append(r)
            if not added and not removed:
                return False
            self._apply_incremental(added, removed)
            self._compute_checksum()
            self._emit(RingChangedEvent(servers_added=added, servers_removed=removed))
            return True

    # -- queries ------------------------------------------------------------

    def has_server(self, address: str) -> bool:
        with self._lock:
            return address in self._server_tokens

    def servers(self) -> list[str]:
        with self._lock:
            return sorted(self._server_tokens)

    def server_count(self) -> int:
        with self._lock:
            return len(self._server_tokens)

    def checksum(self) -> int:
        with self._lock:
            return self._checksum

    def lookup(self, key: str) -> Optional[str]:
        """Owner of ``key`` (parity: ``hashring.go:260-266``)."""
        owners = self.lookup_n(key, 1)
        return owners[0] if owners else None

    def lookup_n(self, key: str, n: int) -> list[str]:
        """N unique owners walking the ring upward from farm32(key) with
        wraparound, in ring order (parity: ``hashring.go:271-301``)."""
        return self._lookup_n_hash(self.hashfunc(key) & 0xFFFFFFFF, n)

    def _lookup_n_hash(self, h: int, n: int) -> list[str]:
        """The exact ring walk from a precomputed 32-bit hash."""
        with self._lock:
            nservers = len(self._server_list)
            if nservers == 0 or n <= 0:
                return []
            if n == 1:
                # single-owner fast path: the first token >= h owns the key
                toks = self._tokens_list
                if not toks:  # servers with replica_points=0 -> no tokens
                    return []
                idx = bisect.bisect_left(toks, h)
                if idx == len(toks):
                    idx = 0
                return [self._server_list[self._owners_list[idx]]]
            if n >= nservers:
                n = nservers
            start = int(np.searchsorted(self._tokens, np.uint64(h), side="left"))
            out: list[str] = []
            seen: set[int] = set()
            t = self._tokens.shape[0]
            for i in range(t):
                owner = int(self._owners[(start + i) % t])
                if owner not in seen:
                    seen.add(owner)
                    out.append(self._server_list[owner])
                    if len(out) == n:
                        break
            return out

    def lookup_n_batch(self, keys: list[str], n: int) -> list[list[str]]:
        """Exact N-owner walk for many keys; each row is ``lookup_n(key, n)``
        (parity: ``hashring.go:271-301``, batched)."""
        with self._lock:
            if not self._server_list or not keys or n <= 0:
                return [[] for _ in keys]
            n = min(n, len(self._server_list))
            rows = ring_lookup_n_batch(
                self._tokens32,
                self._owners32,
                len(self._server_list),
                self._hash_keys(keys),
                n,
            )
            return [
                [self._server_list[int(o)] for o in row if o >= 0] for row in rows
            ]

    def lookup_batch(self, keys: list[str]) -> list[Optional[str]]:
        """Vectorized single-owner lookup for many keys at once."""
        with self._lock:
            if not self._server_list or not self._tokens.shape[0]:
                return [None] * len(keys)
            hashes = self._hash_keys(keys).astype(np.uint64)
            idx = np.searchsorted(self._tokens, hashes, side="left")
            idx = np.where(idx == self._tokens.shape[0], 0, idx)
            owners = self._owners[idx]
            return [self._server_list[int(o)] for o in owners]

    # -- raw arrays for the device ops path ---------------------------------

    def token_arrays(self) -> tuple[np.ndarray, np.ndarray, list[str]]:
        """(tokens uint32-sorted-as-uint64, owner-ids, server list) snapshot
        for handoff to ``ringpop_tpu_torch.ops.ring_ops``."""
        with self._lock:
            return self._tokens.copy(), self._owners.copy(), list(self._server_list)
