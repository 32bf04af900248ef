"""RingService: the micro-batching device-ring lookup service.

Frontends call ``("serve", "/lookup")`` with a key-hash batch
(``net.channel.encode_array`` payload); the collector appends it to the
pending queue and flushes — ONE padded-ring dispatch for everything
pending — when either trigger fires:

* **size**: pending keys reach ``max_batch``;
* **latency**: ``flush_us`` microseconds elapsed since the first pending
  request (``flush_us=0`` degrades gracefully: the flush runs on the next
  event-loop iteration, still coalescing everything that arrived in the
  same iteration — the B=1 single-frontend case pays one loop hop over a
  direct dispatch, which is what keeps its latency within 2× of the raw
  ``ring_lookup`` call).

Coalesced hashes are padded to the next power of two before dispatch so
the set of launch shapes is bounded (log₂ shapes, not one per batch
size); the device wait runs in an executor so the event loop keeps
reading frames while the card computes — flushes pipeline.

Telemetry rides the r7 plumbing: batch-size / queue-wait / dispatch-time
histograms + counters, emitted as ``ringpop.serve.*`` through any
``StatsReporter``, aggregated into one ``kind: "serve"`` JSONL record per
``journal_every`` flushes, with one ``kind: "ring_update"`` record per
committed generation (schema: OBSERVABILITY.md).  Every response carries
the generation the DEVICE answered with (``serve_lookup`` reads it from
the same state in the same dispatch), so owner decisions are certifiable
per membership generation.

Counterpart of ``ringpop_tpu/serve/service.py``: the same names,
arguments, endpoints, journal records and stat names.  The flush gathers
every request once into an int64 staging buffer (the port's
uint32-as-int64 convention) and moves it to the store's device; a
dispatch that meets a ring recommitted under it (``StaleRingError``, the
JAX package's "deleted buffer") retries against a fresh snapshot.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

import numpy as np
import torch

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch.net.channel import decode_array, encode_array
from ringpop_tpu_torch.ops.ring_ops import host_lookup_n
from ringpop_tpu_torch.serve.state import (
    RingStore,
    StaleRingError,
    serve_lookup_fused,
    serve_lookup_n_fused,
)
from ringpop_tpu_torch.util.metrics import Histogram

_logger = logging_mod.logger("serve")

SERVE_STAT_PREFIX = "ringpop.serve"


class _PendingReq:
    __slots__ = ("hashes", "n", "sink", "t_enqueue")

    def __init__(self, hashes: np.ndarray, n: int, sink, t_enqueue: float):
        self.hashes = hashes
        self.n = n
        # an asyncio.Future (TCP path) or a plain callable(rows, gen)
        # (shared-memory path — delivered synchronously, no loop hop)
        self.sink = sink
        self.t_enqueue = t_enqueue


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 1).bit_length() if x > 2 else max(x, 1)


def _fail_sinks(reqs, exc: Exception) -> None:
    """Deliver a dispatch failure to every request: futures get the
    exception, callback sinks get ``(None, -1)`` (the shm server answers
    STATUS_ERR) — a sink is NEVER stranded pending."""
    for r in reqs:
        sink = r.sink
        if isinstance(sink, asyncio.Future):
            if not sink.done():
                sink.set_exception(exc)
        else:
            try:
                sink(None, -1)
            except Exception:  # pragma: no cover - responder must not throw
                pass


class ServeTelemetry:
    """Per-flush counters/histograms + the aggregated journal record."""

    def __init__(self, journal=None, stats=None, journal_every: int = 64):
        self.journal = journal
        self.stats = stats
        self.journal_every = journal_every
        self.reset_window()
        self.flushes_total = 0
        self.keys_total = 0
        self.requests_total = 0

    def reset_window(self):
        self.batch_hist = Histogram(sample_size=64)
        self.wait_hist = Histogram(sample_size=64)
        self.dispatch_hist = Histogram(sample_size=64)
        self.w_flushes = 0
        self.w_keys = 0
        self.w_requests = 0

    def flush_event(
        self, *, keys: int, requests: int, waits_us: list[float],
        dispatch_us: float, gen: int,
    ) -> None:
        self.flushes_total += 1
        self.keys_total += keys
        self.requests_total += requests
        self.w_flushes += 1
        self.w_keys += keys
        self.w_requests += requests
        self.batch_hist.update(keys)
        for w in waits_us:
            self.wait_hist.update(w)
        self.dispatch_hist.update(dispatch_us)
        if self.stats is not None:
            self.stats.incr(f"{SERVE_STAT_PREFIX}.keys", keys)
            self.stats.incr(f"{SERVE_STAT_PREFIX}.requests", requests)
            self.stats.incr(f"{SERVE_STAT_PREFIX}.flushes", 1)
            self.stats.timing(f"{SERVE_STAT_PREFIX}.dispatch", dispatch_us / 1e6)
            self.stats.gauge(f"{SERVE_STAT_PREFIX}.generation", gen)
        if self.journal is not None and self.w_flushes >= self.journal_every:
            self.journal_window(gen)

    def _hist_row(self, h: Histogram) -> dict:
        return {
            "mean": round(h.mean(), 2),
            "p50": round(h.percentile(0.5), 2),
            "p90": round(h.percentile(0.9), 2),
            "max": round(h.max(), 2),
        }

    def journal_window(self, gen: int) -> None:
        if self.journal is None or self.w_flushes == 0:
            self.reset_window()
            return
        self.journal._write(
            {
                "kind": "serve",
                "gen": gen,
                "flushes": self.w_flushes,
                "requests": self.w_requests,
                "keys": self.w_keys,
                "keys_per_flush": self._hist_row(self.batch_hist),
                "queue_wait_us": self._hist_row(self.wait_hist),
                "dispatch_us": self._hist_row(self.dispatch_hist),
            }
        )
        self.reset_window()


class RingService:
    """The shared-ring lookup service; attach to any Base/TCP/Local channel."""

    def __init__(
        self,
        store: RingStore,
        *,
        max_batch: int = 8192,
        flush_us: float = 200.0,
        inline_resolve_max: int = 4096,
        journal=None,
        stats=None,
        journal_every: int = 64,
    ):
        self.store = store
        self.max_batch = max_batch
        self.flush_us = flush_us
        # flushes at or under this many keys resolve INLINE (block the loop
        # on the device result) instead of hopping through the executor —
        # the executor pipelines big dispatches, but its two thread
        # hand-offs dominate a microsecond-scale lookup and would sink the
        # B=1 latency bar; 0 forces the executor always
        self.inline_resolve_max = inline_resolve_max
        self.telemetry = ServeTelemetry(
            journal=journal, stats=stats, journal_every=journal_every
        )
        self._pending: list[_PendingReq] = []
        self._pending_keys = 0
        self._flush_handle: Optional[asyncio.TimerHandle] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._codec = "json"
        # generation updates journal through the store's hook — CHAINED
        # after any caller-installed callback, never replacing it
        prev_hook = store.on_update

        def _chained(record: dict) -> None:
            self._on_ring_update(record)
            if prev_hook is not None:
                prev_hook(record)

        store.on_update = _chained

    # -- wiring ---------------------------------------------------------------

    def attach(self, channel) -> None:
        """Register the serve endpoints on a listening channel.  Response
        arrays ride the channel's codec (raw bytes under msgpack, base64
        under JSON — ``net.channel.encode_array``)."""
        self._codec = getattr(channel, "codec", "json")
        channel.register("serve", "/lookup", self._handle_lookup)
        channel.register("serve", "/ring", self._handle_ring)
        channel.register("serve", "/stats", self._handle_stats)

    def _on_ring_update(self, record: dict) -> None:
        if self.telemetry.journal is not None:
            self.telemetry.journal._write(record)
        if self.telemetry.stats is not None:
            self.telemetry.stats.gauge(
                f"{SERVE_STAT_PREFIX}.ring.servers", record["n_servers"]
            )
            self.telemetry.stats.incr(f"{SERVE_STAT_PREFIX}.ring.changed", 1)

    # -- request path ---------------------------------------------------------

    def submit(self, hashes, n: int = 1, loop=None) -> asyncio.Future:
        """Enqueue one key-hash batch into the collector; the returned
        future resolves to ``(owners, generation)``.  This is the ONE
        entry point both transports share — the TCP ``/lookup`` endpoint
        and the shared-memory server feed the same pending queue, so
        cross-transport requests coalesce into the same dispatches.

        ``hashes`` may be a READ-ONLY VIEW of a transport buffer (r21
        registered-buffer zero-copy): the collector never mutates it and
        consumes it in the flush's single staging gather — the caller
        must keep the buffer stable until its sink is delivered (the shm
        server holds the slot unpublished exactly that long).  The gather
        is a host copy that ends before the flush returns, so no device
        transfer ever reads the transport buffer itself."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        loop = loop or asyncio.get_event_loop()
        self._loop = loop
        fut: asyncio.Future = loop.create_future()
        self._pending.append(_PendingReq(hashes, n, fut, time.perf_counter()))
        self._pending_keys += len(hashes)
        if self._pending_keys >= self.max_batch:
            self._schedule_flush(immediate=True)
        elif self._flush_handle is None:
            if self.flush_us <= 0:
                self._flush_handle = loop.call_soon(self._flush)
            else:
                self._flush_handle = loop.call_later(self.flush_us / 1e6, self._flush)
        return fut

    def submit_nowait(self, hashes, n: int, callback, loop=None) -> None:
        """Enqueue with a synchronous delivery callback and NO flush
        scheduling — the shared-memory server enqueues every pending slot
        it scanned, then calls :meth:`flush_now` once, so an entire scan
        coalesces into one dispatch (plus whatever TCP requests were
        already pending) with zero event-loop hand-offs on the response
        path.  ``callback(rows, gen)`` may run on the executor thread for
        over-``inline_resolve_max`` flushes."""
        if n < 1:
            raise ValueError(f"n must be >= 1, got {n}")
        if loop is not None:
            self._loop = loop
        self._pending.append(_PendingReq(hashes, n, callback, time.perf_counter()))
        self._pending_keys += len(hashes)
        if self._pending_keys >= self.max_batch:
            self._schedule_flush(immediate=True)

    def flush_now(self) -> None:
        """Dispatch everything pending immediately (cancels any armed
        latency trigger)."""
        self._schedule_flush(immediate=True)

    def dispatch_direct(self, hashes, n: int, callback) -> None:
        """The degenerate-case fast lane: ONE small (≤64-key) request,
        nothing else pending — answered from the HOST MIRROR of the
        committed generation (``RingStore.snapshot_host``), bit-identical
        to the device ring by the property-suite pin, without paying a
        device round trip a single key cannot amortize (the batch path
        exists precisely to spread a dispatch's fixed cost over thousands
        of keys).  n>1 point
        requests answer from the SAME mirror through the exact
        ``host_lookup_n`` walk (the LookupNUniqueAt parity oracle), so the
        fast lane returns the same (owner, successors) tuple the fused
        device dispatch would.  Telemetered as a flush of one request, so
        the B=1 stream shows up in the same batch-size/queue-wait
        histograms."""
        t0 = time.perf_counter()
        toks, owns, gen, n_servers = self.store.snapshot_host()
        if n == 1:
            if toks.shape[0] == 0:
                rows = np.full(len(hashes), -1, np.int32)
            else:
                idx = np.searchsorted(toks, np.asarray(hashes, np.uint32), side="left")
                rows = owns[np.where(idx == toks.shape[0], 0, idx)]
        else:
            rows = host_lookup_n(toks, owns, hashes, n, n_servers)
        callback(rows, gen)
        self.telemetry.flush_event(
            keys=len(hashes), requests=1, waits_us=[0.0],
            dispatch_us=(time.perf_counter() - t0) * 1e6, gen=gen,
        )

    async def _handle_lookup(self, body: dict, headers: dict) -> dict:
        hashes = decode_array(body["h"], "<u4")
        n = int(body.get("n", 1))
        owners, gen = await self.submit(hashes, n=n)
        return {
            "o": encode_array(owners, self._codec, "<i4"),
            "gen": gen,
            "n": n,
        }

    async def _handle_ring(self, body: dict, headers: dict) -> dict:
        gen = body.get("gen")
        with self.store._lock:
            cur = self.store.gen
        servers = (
            self.store.servers_at(int(gen)) if gen is not None
            else self.store.servers_at(cur)
        )
        if servers is None:
            raise ValueError(f"generation {gen} aged out (current {cur})")
        return {
            "gen": int(gen) if gen is not None else cur,
            "current_gen": cur,
            "servers": servers,
            "checksum": self.store.ring.checksum(),
        }

    async def _handle_stats(self, body: dict, headers: dict) -> dict:
        t = self.telemetry
        return {
            "flushes": t.flushes_total,
            "requests": t.requests_total,
            "keys": t.keys_total,
            "keys_per_flush_mean": round(
                t.keys_total / max(t.flushes_total, 1), 2
            ),
            "gen": self.store.gen,
        }

    # -- the collector --------------------------------------------------------

    def _schedule_flush(self, immediate: bool = False) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        if immediate:
            self._flush()

    def _flush(self) -> None:
        self._flush_handle = None
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        self._pending_keys = 0
        loop = self._loop or asyncio.get_event_loop()
        t_flush = time.perf_counter()
        waits_us = [(t_flush - r.t_enqueue) * 1e6 for r in batch]
        # group by n: n=1 rides the single serve_lookup program; each n > 1
        # group is its own exact preference-list dispatch
        groups: dict[int, list[_PendingReq]] = {}
        for r in batch:
            groups.setdefault(r.n, []).append(r)
        gen = self.store.gen  # fallback if every group's dispatch fails
        for n, reqs in groups.items():
            # requests may hand in read-only views of transport buffers
            # (shm ring slots).  Gather them ONCE, directly into the padded
            # int64 staging buffer the device upload reads (the uint32 ->
            # int64 widening rides the same copy): one host copy of every
            # payload byte, after which the transport buffers are free to
            # be republished.  A lone request is gathered too — the upload
            # never reads a slot itself.
            total = sum(int(r.hashes.shape[0]) for r in reqs)
            staging = np.zeros(_next_pow2(total), np.int64)
            off = 0
            for r in reqs:
                b = int(r.hashes.shape[0])
                staging[off:off + b] = r.hashes
                off += b
            dev_hashes = torch.from_numpy(staging).to(self.store.torch_device)
            try:
                # journal the generation the dispatch ACTUALLY answered
                # with — the retry path may refetch a newer snapshot
                gen = self._dispatch_group(loop, reqs, dev_hashes, total, n)
            except Exception as e:  # deliver, never strand a sink
                _logger.error(f"serve flush dispatch failed: {e!r}")
                _fail_sinks(reqs, e)
        dispatch_us = (time.perf_counter() - t_flush) * 1e6
        self.telemetry.flush_event(
            keys=sum(len(r.hashes) for r in batch),
            requests=len(batch),
            waits_us=waits_us,
            dispatch_us=dispatch_us,
            gen=gen,
        )

    def _dispatch_group(self, loop, reqs, dev_hashes, total: int, n: int) -> int:
        """One group's dispatch, retried on a recommitted ring: the store's
        ping-pong keeps a snapshot valid across ONE concurrent commit, so
        a ``StaleRingError`` means TWO membership changes landed around
        this dispatch — refetch the newest generation and redo (the answer
        then rightly carries the newer generation).  Nothing else is
        retried.  Returns the generation of the snapshot that answered."""
        for attempt in range(5):
            ring, _gen, n_servers = self.store.snapshot()
            try:
                # fused transfer either way: owners + generation in one
                # device array (generation in the tail slot), split
                # host-side after a single sync — n=1 rides the plain
                # fused program, n>1 the fused preference-list windows
                if n == 1:
                    owners_dev = serve_lookup_fused(ring, dev_hashes)
                else:
                    owners_dev = serve_lookup_n_fused(ring, n_servers, dev_hashes, n)
                if total <= self.inline_resolve_max:
                    # small flush: the device answer is microseconds away
                    # and two executor hand-offs would dominate it
                    self._resolve(reqs, owners_dev, total, n, inline=True)
                else:
                    task = loop.run_in_executor(
                        None, self._resolve, reqs, owners_dev, total, n
                    )
                    task.add_done_callback(self._log_resolve_error)
                return _gen
            except StaleRingError:
                if attempt == 4:
                    raise
        return _gen  # pragma: no cover - loop always returns or raises

    @staticmethod
    def _log_resolve_error(task) -> None:
        exc = task.exception()
        if exc is not None:  # pragma: no cover - resolve() sets futures
            _logger.error(f"serve flush resolve failed: {exc!r}")

    def _resolve(
        self, reqs, owners_dev, total: int, n: int, inline: bool = False
    ) -> None:
        """Block on the device result and scatter rows back to request
        futures — on the loop thread directly (``inline``) or from the
        executor (thread-safe via call_soon_threadsafe).  ``owners_dev``
        is the fused vector with the generation in its tail slot: [B+1]
        for n=1, [B*n+1] flattened rows for preference lists.  Its
        ``.cpu()`` waits for this flush's answer only.

        The JAX package also requeues here, when the executor's transfer
        meets a ring buffer retired mid-transfer.  That has no trigger in
        the port: the fused answer is a tensor of its own, which no commit
        writes, so every stale ring surfaces at dispatch, where
        :meth:`_dispatch_group` retries it."""
        host = owners_dev.cpu().numpy()
        gen = int(host[-1])
        if n == 1:
            owners = host[:total]
        else:
            owners = host[: total * n].reshape(total, n)
        loop = self._loop
        off = 0
        for r in reqs:
            b = len(r.hashes)
            rows = owners[off : off + b]
            off += b
            if not isinstance(r.sink, asyncio.Future):
                # callback sink: deliver synchronously (slot-exclusive,
                # safe from any thread)
                r.sink(rows, gen)
                continue

            def _set(fut=r.sink, rows=rows):
                if not fut.done():
                    fut.set_result((rows, gen))

            if inline:
                _set()
            else:
                loop.call_soon_threadsafe(_set)
