"""Device-resident ring state with generation-certified swaps.

Counterpart of ``ringpop_tpu/serve/state.py``.  ``DeviceRing`` keeps the
serving ring's sorted token/owner tensors at a fixed CAPACITY on the device
(``ops/ring_ops.py`` padded variants), with the live count and a generation
counter as device tensors.  Updates are value swaps at constant shape:
``ring_commit`` copies a new generation IN PLACE into a retired ring's
tensors, and ``RingStore`` ping-pongs two such buffer sets, so churn never
allocates and a snapshot stays valid across one concurrent commit.  A
snapshot two commits old, whose tensors now hold a newer generation, is
refused by every lookup with :class:`StaleRingError` (the JAX version's
donated buffers raise "deleted buffer" there): each buffer set carries a
host-side commit count, so the check costs no device sync.

``serve_lookup`` returns the generation alongside the owners, read from the
same device state in the same stream order — the answer and the membership
generation it was computed against are paired, which is what lets a
serving tier certify routing decisions per generation.

``RingStore`` is the host-side feed: it owns a ``hashring.HashRing``
(incremental token add/remove), pads, commits, and returns one
``ring_update`` record per generation.  ``listen_to`` subscribes it to any
``RingChangedEvent`` emitter.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.events import RingChangedEvent
from ringpop_tpu_torch.hashring import HashRing
from ringpop_tpu_torch.ops.ring_ops import (
    _lookup_n_window_padded,
    pad_ring_arrays,
    ring_lookup_n_padded,
    ring_lookup_padded,
)


class RingEpoch:
    """The host-side commit count of one buffer set: :func:`ring_commit`
    adds one each time it overwrites the set's tensors."""

    __slots__ = ("commits",)

    def __init__(self) -> None:
        self.commits = 0


class StaleRingError(RuntimeError):
    """A lookup through a ``DeviceRing`` view whose tensors a later
    :func:`ring_commit` has overwritten with a newer generation.  Take a
    fresh ``RingStore.snapshot()`` and retry."""


class DeviceRing(NamedTuple):
    """The device-resident serving ring (capacity-padded)."""

    tokens: torch.Tensor  # int64[C] holding uint32 tokens, PAD_TOKEN past count
    owners: torch.Tensor  # int32[C], -1 past count
    count: torch.Tensor  # int32[1] live tokens
    gen: torch.Tensor  # int64[1] membership generation (a uint32 value)
    # (the buffer set's RingEpoch, its commit count when this view was made)
    epoch: Optional[tuple[RingEpoch, int]] = None


def check_current(ring: DeviceRing) -> None:
    """Raise :class:`StaleRingError` when a commit has overwritten the
    tensors of this view since it was made (a host-side check)."""
    if ring.epoch is not None and ring.epoch[0].commits != ring.epoch[1]:
        raise StaleRingError(
            f"this ring view is stale: its buffers were recommitted {ring.epoch[0].commits - ring.epoch[1]} "
            "time(s) since it was taken and now hold a newer generation; take a fresh snapshot"
        )


def device_ring_from_numpy(tokens, owners, count, gen, device: DeviceLike = None) -> DeviceRing:
    """A DeviceRing from host leaves in the JAX package's layout — uint32[C]
    tokens, int32[C] owners, int32[1] count, uint32[1] gen (e.g. the leaves of
    a ``ringpop_tpu`` ``DeviceRing`` through ``np.asarray``) — on ``device``."""
    dev = resolve_device(device)

    def leaf(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(dtype))).to(dev)

    return DeviceRing(
        tokens=leaf(tokens, np.int64),
        owners=leaf(owners, np.int32),
        count=leaf(np.asarray(count).reshape(1), np.int32),
        gen=leaf(np.asarray(gen).reshape(1), np.int64),
        epoch=(RingEpoch(), 0),
    )


def device_ring(tokens, owners, capacity: int, gen: int = 0, device: DeviceLike = None) -> DeviceRing:
    """Host arrays -> a fresh DeviceRing at ``capacity`` on ``device`` (the
    card by default)."""
    pt, po, count = pad_ring_arrays(tokens, owners, capacity)
    return device_ring_from_numpy(pt, po, [count], [gen], device)


def ring_commit(
    ring: DeviceRing, tokens: torch.Tensor, owners: torch.Tensor, count: torch.Tensor,
    gen: torch.Tensor,
) -> DeviceRing:
    """Copy a new generation IN PLACE into ``ring``'s tensors (full length,
    offset 0) and return a view of them at the new generation.
    ``RingStore`` ping-pongs two buffer sets through this: commit N
    overwrites generation N-2's tensors, so a reader holding the previous
    snapshot stays valid across one concurrent commit (peak device memory
    is two rings, and churn never allocates).

    The JAX version donates the old buffers, so a read of a snapshot TWO
    generations old raises "deleted buffer".  Here the tensors live on,
    holding the new generation; the commit advances their buffer set's
    host-side count instead, so every lookup through an older view raises
    :class:`StaleRingError` rather than reading the newer ring."""
    epoch = ring.epoch[0] if ring.epoch is not None else RingEpoch()
    ring.tokens.copy_(tokens)
    ring.owners.copy_(owners)
    ring.count.copy_(count)
    ring.gen.copy_(gen)
    epoch.commits += 1
    return ring._replace(epoch=(epoch, epoch.commits))


def serve_lookup(ring: DeviceRing, key_hashes) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-owner lookup + the generation it was answered against:
    (int32[B] owners, int64[1] gen — a copy, so a later commit into this
    ring's buffers cannot change it)."""
    check_current(ring)
    return (
        ring_lookup_padded(ring.tokens, ring.owners, ring.count[0], key_hashes),
        ring.gen.clone(),
    )


def serve_lookup_fused(ring: DeviceRing, key_hashes) -> torch.Tensor:
    """:func:`serve_lookup` with the generation FUSED into the owner vector
    (int32[B+1], generation in the last slot) — one device tensor, one host
    transfer."""
    check_current(ring)
    owners = ring_lookup_padded(ring.tokens, ring.owners, ring.count[0], key_hashes)
    return torch.cat([owners, ring.gen.to(torch.int32)])


def serve_lookup_n(ring: DeviceRing, num_servers, key_hashes, n: int):
    """N-owner preference-list lookup against the padded ring (exact — the
    window-doubling rescue of ``ring_lookup_n_padded``)."""
    check_current(ring)
    return (
        ring_lookup_n_padded(
            ring.tokens, ring.owners, ring.count[0], num_servers, key_hashes, n
        ),
        ring.gen.clone(),
    )


def _serve_lookup_n_window_fused(ring: DeviceRing, num_servers, key_hashes, n: int, w: int):
    """One fused window pass of the LookupN serve dispatch: the padded
    windowed scan with the generation CONCATENATED into the flattened owner
    matrix.  Returns ``(int32[B*n + 1] fused, bool tensor satisfied)``."""
    check_current(ring)
    out, found = _lookup_n_window_padded(
        ring.tokens, ring.owners, ring.count[0], key_hashes, n, w
    )
    fused = torch.cat([out.reshape(-1), ring.gen.to(torch.int32)])
    need = torch.clamp(torch.as_tensor(num_servers, device=found.device), max=n)
    return fused, (found >= need).all()


def serve_lookup_n_fused(ring: DeviceRing, num_servers, key_hashes, n: int) -> torch.Tensor:
    """:func:`serve_lookup_n` with the generation FUSED into the owner
    vector: int32[B*n + 1], rows flattened row-major, generation in the last
    slot.  EXACT: the same window-doubling rescue as
    ``ring_lookup_n_padded``, decided on the host with one ``bool`` read per
    window."""
    check_current(ring)
    c = int(ring.tokens.shape[0])
    b = int(torch.as_tensor(key_hashes).shape[0])
    if c == 0 or n <= 0:
        return torch.cat(
            [torch.full((b * max(n, 0),), -1, dtype=torch.int32, device=ring.gen.device),
             ring.gen.to(torch.int32)]
        )
    w = min(max(4 * n, 16), c)
    while True:
        fused, ok = _serve_lookup_n_window_fused(ring, num_servers, key_hashes, n, w)
        # w >= capacity >= count covers the whole live ring: exact
        if w >= c or bool(ok):
            return fused
        w = min(2 * w, c)


class RingStore:
    """Host-side owner of the DeviceRing: membership in, generations out.

    Capacity doubles (one reallocation) when the server set outgrows it;
    every committed generation's server list is retained in a short ring
    buffer so responses tagged with a recent generation can still be
    resolved to addresses.  Only ``placement="random"`` (the ring's own
    placement) exists in this package so far; ``"dgro"`` raises
    NotImplementedError.
    """

    def __init__(
        self,
        servers: Optional[list[str]] = None,
        *,
        replica_points: int = 100,
        capacity: Optional[int] = None,
        keep_generations: int = 8,
        placement: str = "random",
        on_update: Optional[Callable[[dict], None]] = None,
        device: DeviceLike = None,
    ):
        if placement == "dgro":
            raise NotImplementedError("placement='dgro' is not ported yet")
        if placement != "random":
            raise ValueError(f"unknown placement {placement!r}")
        self.torch_device = resolve_device(device)
        self._lock = threading.Lock()
        self.ring = HashRing(replica_points=replica_points)
        self.placement = placement
        self.keep_generations = keep_generations
        self.on_update = on_update
        self._gens: dict[int, list[str]] = {}
        self.gen = 0
        if servers:
            self.ring.add_remove_servers(list(servers), [])
        count = self.ring._tokens.shape[0]
        cap = capacity if capacity is not None else max(2 * count, 1024)
        tokens, owners = self._placed_arrays()
        self.device = device_ring(tokens, owners, cap, gen=self.gen, device=self.torch_device)
        # host mirror of the COMMITTED arrays (the point-lookup fast lane)
        self.host_tokens = np.asarray(tokens, np.uint32)
        self.host_owners = np.asarray(owners, np.int32)
        self.capacity = cap
        # the generation before last, whose buffers the NEXT value-swap
        # commit overwrites (ping-pong)
        self._retired: Optional[DeviceRing] = None
        self._gens[self.gen] = self.ring.servers()

    # -- placement -----------------------------------------------------------

    def _placed_arrays(self):
        """(tokens uint32, owners int32) for the current server set — the
        ring's own (reference hashring.go) placement."""
        toks, owners, _ = self.ring.token_arrays()
        return toks.astype(np.uint32), owners.astype(np.int32)

    # -- mutation ------------------------------------------------------------

    def update(self, add=None, remove=None) -> Optional[dict]:
        """Apply one membership change and commit the next generation.
        Returns the ``ring_update`` record (None on no-op)."""
        with self._lock:
            if not self.ring.add_remove_servers(list(add or []), list(remove or [])):
                return None
            return self._commit(added=list(add or []), removed=list(remove or []))

    def drain(self, servers) -> Optional[dict]:
        """Route a degrading server's ring block away before its peers
        declare it faulty: remove it and commit the next generation, stamped
        ``"drain": True``.  Returns the record (None when none of the
        servers are in the ring)."""
        with self._lock:
            removed = list(servers)
            if not self.ring.add_remove_servers([], removed):
                return None
            return self._commit(added=[], removed=removed, drain=True)

    def rescore_placement(self) -> Optional[dict]:
        """Re-score the DGRO placement; only meaningful under
        ``placement="dgro"``, so None here, as in the JAX version under
        random placement."""
        return None

    def _commit(
        self,
        added: list[str],
        removed: list[str],
        drain: bool = False,
    ) -> dict:
        tokens, owners = self._placed_arrays()
        self.host_tokens = np.asarray(tokens, np.uint32)
        self.host_owners = np.asarray(owners, np.int32)
        count = int(tokens.shape[0])
        if count > self.capacity:
            # outgrown: reallocate at double capacity.  Both resident buffer
            # sets have the old capacity, so the ping-pong restarts.
            self.capacity = max(2 * count, 2 * self.capacity)
            self.gen += 1
            self.device = device_ring(
                tokens, owners, self.capacity, gen=self.gen, device=self.torch_device
            )
            self._retired = None
            reallocated = True
        else:
            pt, po, count = pad_ring_arrays(tokens, owners, self.capacity)
            self.gen += 1
            if self._retired is not None:
                new = ring_commit(
                    self._retired,
                    torch.from_numpy(pt.astype(np.int64)),
                    torch.from_numpy(po),
                    torch.tensor([count], dtype=torch.int32),
                    torch.tensor([self.gen], dtype=torch.int64),
                )
            else:
                new = device_ring(
                    tokens, owners, self.capacity, gen=self.gen, device=self.torch_device
                )
            self._retired = self.device
            self.device = new
            reallocated = False
        self._gens[self.gen] = self.ring.servers()
        for g in list(self._gens):
            if g <= self.gen - self.keep_generations:
                del self._gens[g]
        record = {
            "kind": "ring_update",
            "gen": self.gen,
            "checksum": self.ring.checksum(),
            "n_servers": self.ring.server_count(),
            "count": count,
            "capacity": self.capacity,
            "reallocated": reallocated,
            "added": added,
            "removed": removed,
        }
        if drain:
            record["drain"] = True
        if self.on_update is not None:
            self.on_update(record)
        return record

    # -- live feed -----------------------------------------------------------

    def listen_to(self, emitter_owner) -> None:
        """Subscribe to a ``RingChangedEvent`` source (a ``HashRing`` or
        anything exposing ``register_listener``).  Each event becomes one
        committed generation."""
        store = self

        class _L:
            def handle_event(self, event):
                if isinstance(event, RingChangedEvent):
                    store.update(event.servers_added, event.servers_removed)

        emitter_owner.register_listener(_L())

    # -- queries -------------------------------------------------------------

    def snapshot(self) -> tuple[DeviceRing, int, int]:
        """(device ring, generation, n_servers) — one consistent view."""
        with self._lock:
            return self.device, self.gen, self.ring.server_count()

    def snapshot_host(self) -> tuple[np.ndarray, np.ndarray, int, int]:
        """(host tokens, host owners, generation, n_servers) — the committed
        generation's arrays, for the point-lookup fast lane."""
        with self._lock:
            return self.host_tokens, self.host_owners, self.gen, self.ring.server_count()

    def servers_at(self, gen: int) -> Optional[list[str]]:
        """Server list of a recent generation (None if aged out)."""
        with self._lock:
            return self._gens.get(gen)
