"""Shared-memory request ring: the serve tier's same-host fast transport.

The TCP path (``net/channel.py`` framing) is general but prices every
batch at one frame encode/decode plus a socket round trip — fine across
hosts, throwaway overhead for frontends that share the machine with the
device ring.  This module gives those frontends a zero-copy-in,
zero-serialization lane: one shared-memory segment holds S fixed-size
request slots (one per frontend); a client writes its key hashes
directly into its slot, bumps a sequence word, and pokes a 1-byte UNIX
datagram at the server's wakeup socket; the server's event loop scans
all slots on wake and feeds every pending request into the SAME
micro-batching collector the TCP endpoints use — so cross-frontend
coalescing is structural (one scan picks up every frontend that posted
during the last dispatch), not timer-dependent.

Slot protocol (all words uint32, x86-TSO-ordered numpy stores):

* client: write ``count``/``n`` + hashes, THEN ``req_seq += 1``, then
  wake the server (datagram).  Spin on ``resp_seq == req_seq``.
* server: slot pending iff ``req_seq != resp_seq`` and not in flight;
  write owners + ``gen``/``status``, THEN ``resp_seq = req_seq``.

The sequence words make the payload hand-off safe without locks: each
side only reads the other's payload after observing the matching seq,
and each writes its payload strictly before publishing its seq.

Counterpart of ``ringpop_tpu/serve/shm.py``: the same slot layout and
seq-word protocol, byte for byte, so either package's client talks to
either's server.  Imports no torch.
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from multiprocessing import shared_memory
from typing import Optional

import numpy as np

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch.errors import FabricPeerLost, FabricTimeout
from ringpop_tpu_torch.parallel.fabric import TransportLedger

_logger = logging_mod.logger("serve.shm")

# per-slot header words (uint32)
_REQ_SEQ = 0  # client bumps after writing a request
_RESP_SEQ = 1  # server sets == req_seq after writing the response
_COUNT = 2  # keys in the request
_N = 3  # owners requested per key
_GEN = 4  # response: membership generation that answered
_STATUS = 5  # response: 0 ok, 1 error (count/n out of bounds)
_HEADER_WORDS = 8

STATUS_OK = 0
STATUS_ERR = 1


def _slot_words(key_cap: int, max_n: int) -> int:
    return _HEADER_WORDS + key_cap + key_cap * max_n


class ShmRing:
    """The raw segment: S slots of (header, hashes u32[key_cap],
    owners i32[key_cap * max_n]) — attached by name from any process."""

    def __init__(
        self,
        *,
        slots: int = 16,
        key_cap: int = 1 << 16,
        max_n: int = 4,
        name: Optional[str] = None,
        create: bool = False,
    ):
        self.slots = slots
        self.key_cap = key_cap
        self.max_n = max_n
        nbytes = slots * _slot_words(key_cap, max_n) * 4
        if create:
            self.shm = shared_memory.SharedMemory(create=True, size=nbytes)
        else:
            assert name is not None
            self.shm = shared_memory.SharedMemory(name=name)
        self.name = self.shm.name
        words = np.frombuffer(self.shm.buf, dtype=np.uint32)
        per = _slot_words(key_cap, max_n)
        self._headers = []
        self._hashes = []
        self._owners = []
        for s in range(slots):
            base = s * per
            self._headers.append(words[base : base + _HEADER_WORDS])
            self._hashes.append(words[base + _HEADER_WORDS : base + _HEADER_WORDS + key_cap])
            self._owners.append(
                words[base + _HEADER_WORDS + key_cap : base + per].view(np.int32)
            )
        if create:
            words[:] = 0

    def close(self, unlink: bool = False) -> None:
        # drop the numpy views before closing the mmap (BufferError otherwise)
        self._headers = self._hashes = self._owners = None
        try:
            self.shm.close()
        except BufferError:
            # r21 zero-copy: a dispatch may still hold a slot view (or a
            # CPU tensor aliasing one) at teardown.  Collect the
            # dropped references and retry; if a live view remains, defer
            # the unmap to process exit — unlink below must still happen
            # so the segment name is reclaimed either way.
            import gc

            gc.collect()
            try:
                self.shm.close()
            except BufferError:
                _logger.debug(
                    "shm segment close deferred: exported slot views alive"
                )
        if unlink:
            try:
                self.shm.unlink()
            except FileNotFoundError:  # pragma: no cover - double unlink
                pass


class ShmServer:
    """Server half: owns the segment + the wakeup socket; hands pending
    requests to a ``RingService`` collector and writes responses back."""

    def __init__(self, service, *, slots: int = 16, key_cap: int = 1 << 16,
                 max_n: int = 4, burst_us: float = 500.0,
                 ledger: Optional[TransportLedger] = None):
        self.service = service
        # merged transport accounting (r21), class "shm": request payload
        # bytes read out of the ring, response bytes written back, and
        # ``copy_bytes`` — payload bytes COPIED out of a slot before the
        # dispatch's own staging gather.  The zero-copy contract is that
        # this stays 0: slots are handed to the collector as read-only
        # views and not republished until the dispatch consumed them.
        self.ledger = ledger if ledger is not None else TransportLedger()
        # after SMALL-batch activity (count <= 64: the latency-sensitive
        # point-lookup class) the server keeps rescanning the slots for
        # ``burst_us`` before falling back to the wakeup socket — one epoll
        # hop per BURST of traffic instead of per request, which is what
        # keeps the B=1 sequential stream near direct-dispatch latency.
        # Large batches never arm it: their epoll wake is amortized over
        # thousands of keys, and a polling loop would burn a core the
        # dispatches themselves need (this container has two).
        self.burst_us = burst_us
        self._burst_deadline = 0.0
        self._burst_live = False
        self._small_seen = False
        self.ring = ShmRing(slots=slots, key_cap=key_cap, max_n=max_n, create=True)
        self.sock_path = os.path.join(
            tempfile.gettempdir(), f"rp-serve-{os.getpid()}-{self.ring.name}.sock"
        )
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._sock.bind(self.sock_path)
        self._sock.setblocking(False)
        self._inflight: set[int] = set()
        self._loop = None

    @property
    def address(self) -> tuple[str, str]:
        """(shm segment name, wakeup socket path) — what a client needs."""
        return self.ring.name, self.sock_path

    def attach(self, loop) -> None:
        self._loop = loop
        loop.add_reader(self._sock.fileno(), self._on_wake)

    def _on_wake(self) -> None:
        # drain every queued wake datagram, then scan ALL slots once —
        # the structural coalescing: requests posted by different
        # frontends during the previous dispatch are picked up together
        while True:
            try:
                self._sock.recv(64)
            except BlockingIOError:
                break
        if self.scan() and self._small_seen:
            self._extend_burst()

    def _extend_burst(self) -> None:
        self._burst_deadline = time.perf_counter() + self.burst_us / 1e6
        if not self._burst_live and self._loop is not None and self.burst_us > 0:
            self._burst_live = True
            self._loop.call_soon(self._burst)

    def _burst(self) -> None:
        """Post-activity polling window: rescan via ``call_soon`` (the loop
        still services fds and timers between scans) until ``burst_us``
        passes with no new work, then return to pure epoll waiting."""
        if self.ring._headers is None:  # closed mid-burst
            self._burst_live = False
            return
        if self.scan() and self._small_seen:
            self._burst_deadline = time.perf_counter() + self.burst_us / 1e6
        if time.perf_counter() < self._burst_deadline:
            self._loop.call_soon(self._burst)
        else:
            self._burst_live = False

    def scan(self) -> int:
        """Enqueue every pending slot into the collector, then flush ONCE —
        the whole scan (plus any pending TCP requests) coalesces into a
        single dispatch.  Responses are delivered through synchronous
        callbacks (no event-loop hand-off).  Returns how many slots were
        picked up."""
        ring = self.ring
        found = 0
        self._small_seen = False
        picked: list[tuple[int, int, int, int]] = []  # (slot, req, count, n)
        for s in range(ring.slots):
            if s in self._inflight:
                continue
            hdr = ring._headers[s]
            req = int(hdr[_REQ_SEQ])
            if req == int(hdr[_RESP_SEQ]):
                continue
            count = int(hdr[_COUNT])
            n = int(hdr[_N])
            if not (0 < count <= ring.key_cap and 0 < n <= ring.max_n):
                hdr[_STATUS] = STATUS_ERR
                hdr[_RESP_SEQ] = np.uint32(req)
                continue
            found += 1
            if count <= 64:
                self._small_seen = True
            picked.append((s, req, count, n))
        if not picked:
            return 0
        svc = self.service
        try:
            if len(picked) == 1 and picked[0][2] <= 64 and not svc._pending:
                # degenerate single point-lookup, nothing else pending:
                # skip the collector's grouping/padding machinery entirely
                # — this is the B=1 latency path
                s, req, count, n = picked[0]
                self._inflight.add(s)
                self.ledger.add("shm", lane="shm", bytes_recv=count * 4, frames_recv=1)
                svc.dispatch_direct(
                    self._slot_view(s, count), n, self._responder(s, req)
                )
                return found
            for s, req, count, n in picked:
                self._inflight.add(s)
                self.ledger.add("shm", lane="shm", bytes_recv=count * 4, frames_recv=1)
                # r21 zero-copy: hand the collector a READ-ONLY VIEW of
                # the slot — no copy out of the segment.  Lifetime is
                # explicit: the slot stays in ``_inflight`` (and
                # ``resp_seq`` unpublished, so the client keeps its hands
                # off the buffer) until the responder runs, which is
                # strictly after the dispatch's staging gather consumed
                # the view.  ``flush_now`` below dispatches synchronously
                # within this scan.
                svc.submit_nowait(
                    self._slot_view(s, count), n=n, loop=self._loop,
                    callback=self._responder(s, req),
                )
            svc.flush_now()
        except Exception as e:
            # answer STATUS_ERR for every picked slot the collector did
            # not already respond to — an exception must never strand a
            # slot in _inflight (the frontend would time out forever) nor
            # kill the burst/wake callback chain
            _logger.error(f"shm scan dispatch failed: {e!r}")
            for s, req, _count, _n in picked:
                if s in self._inflight:
                    self._responder(s, req)(None, -1)
        return found

    def _slot_view(self, slot: int, count: int) -> np.ndarray:
        """A read-only numpy view of a slot's pending hashes — the
        registered-buffer hand-off.  Zero bytes are copied; the returned
        view aliases the shared segment and is valid until the slot's
        responder publishes ``resp_seq``."""
        view = self.ring._hashes[slot][:count].view()
        view.flags.writeable = False
        return view

    def _responder(self, slot: int, req: int):
        def respond(rows, gen) -> None:
            ring = self.ring
            hdr = ring._headers[slot]
            if rows is None:  # dispatch failed: the client raises
                hdr[_STATUS] = STATUS_ERR
            else:
                flat = np.asarray(rows, np.int32).reshape(-1)
                ring._owners[slot][: flat.shape[0]] = flat
                hdr[_GEN] = np.uint32(gen)
                hdr[_STATUS] = STATUS_OK
                self.ledger.add("shm", lane="shm", bytes_sent=int(flat.shape[0]) * 4,
                                frames_sent=1)
            self._inflight.discard(slot)
            hdr[_RESP_SEQ] = np.uint32(req)
            # retry-while-held: if the client gave up waiting and posted a
            # NEW request into this slot while the old one was in flight,
            # ``req_seq`` has moved past what we just answered — the wake
            # datagram for it was already drained, so without a rescan the
            # retry would strand until the next unrelated wake.  (This
            # responder may run on the executor thread; scan() is
            # loop-only, hence the threadsafe hop.)
            if int(hdr[_REQ_SEQ]) != req and self._loop is not None:
                try:
                    self._loop.call_soon_threadsafe(self.scan)
                except RuntimeError:  # pragma: no cover - loop shut down
                    pass

        return respond

    def close(self) -> None:
        if self._loop is not None:
            self._loop.remove_reader(self._sock.fileno())
        self._sock.close()
        try:
            os.unlink(self.sock_path)
        except FileNotFoundError:  # pragma: no cover
            pass
        self.ring.close(unlink=True)


class ShmClient:
    """Frontend half: blocking lookups through one owned slot.

    ``lookup_hashes`` is synchronous by design — the frontend's unit of
    work is one posted batch.  The wait is batch-size aware: tiny batches
    (latency-sensitive point lookups) spin hot for up to ``spin_us`` —
    the server's post-activity burst answers them in that window — while
    large batches spin only briefly and then SLEEP in short steps,
    yielding their core to the service doing the actual work (on a
    2-core container a spinning client would starve the very dispatch it
    is waiting on)."""

    def __init__(self, shm_name: str, sock_path: str, slot: int, *,
                 slots: int = 16, key_cap: int = 1 << 16, max_n: int = 4,
                 spin_us: float = 1000.0, timeout: float = 30.0):
        self.ring = ShmRing(slots=slots, key_cap=key_cap, max_n=max_n, name=shm_name)
        self.slot = slot
        self.spin_us = spin_us
        self.timeout = timeout
        self._hdr = self.ring._headers[slot]
        self._hashes = self.ring._hashes[slot]
        self._owners = self.ring._owners[slot]
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._sock.connect(sock_path)

    def lookup_hashes(self, hashes: np.ndarray, n: int = 1):
        """(owners int32[B] or int32[B, n], generation) — blocking."""
        count = int(hashes.shape[0])
        if not (0 < count <= self.ring.key_cap):
            raise ValueError(f"batch of {count} exceeds slot capacity {self.ring.key_cap}")
        if not (0 < n <= self.ring.max_n):
            raise ValueError(f"n={n} outside 1..{self.ring.max_n}")
        hdr = self._hdr
        self._hashes[:count] = np.asarray(hashes, np.uint32)
        hdr[_COUNT] = np.uint32(count)
        hdr[_N] = np.uint32(n)
        # mask before the uint32 construction: at seq 0xFFFFFFFF the +1
        # would overflow (newer numpy raises OverflowError instead of
        # wrapping) — the protocol is modular, wrap-around is legitimate
        req = np.uint32((int(hdr[_REQ_SEQ]) + 1) & 0xFFFFFFFF)
        hdr[_REQ_SEQ] = req
        try:
            self._sock.send(b"\x01")
        except OSError as e:
            # the wakeup socket refusing the datagram means the server
            # process died (its unix socket is gone) — the shm flavor of
            # a dead fabric peer
            raise FabricPeerLost(
                f"shm serve server unreachable at its wakeup socket ({e})"
            ) from e
        t0 = time.perf_counter()
        deadline = t0 + self.timeout
        spin_until = t0 + (self.spin_us if count <= 64 else 50.0) / 1e6
        while hdr[_RESP_SEQ] != req:
            now = time.perf_counter()
            if now > deadline:
                # the unified (r17) transport error family: a silent shm
                # server is the same failure class as a silent fabric or
                # channel peer — FabricTimeout everywhere
                raise FabricTimeout(
                    f"shm lookup timed out after {self.timeout}s — server "
                    "wedged or gone (slot never answered)"
                )
            if now > spin_until:
                time.sleep(1e-4)
        if int(hdr[_STATUS]) != STATUS_OK:
            raise RuntimeError("shm lookup rejected by server")
        owners = self._owners[: count * n].copy()
        gen = int(hdr[_GEN])
        if n > 1:
            return owners.reshape(count, n), gen
        return owners, gen

    def close(self) -> None:
        self._sock.close()
        self._hdr = self._hashes = self._owners = None
        self.ring.close()
