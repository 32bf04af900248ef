"""Span tracing for the forwarding planes — the ``ringpop-trace`` header.

The reference ringpop forwards ONE keyed request per RPC and marks it
with the binary ``ringpop-forwarded`` header; r17's batch plane
generalized that to the ``ringpop-hops`` hop counter.  This module adds
the third header of the family: ``ringpop-trace`` carries ``<trace
id>:<parent span id>`` (8-hex-digit words) alongside ``ringpop-hops``
through ``forward/batch.py``, ``serve/mesh.py`` and ``net/channel.py``,
and every traced leg emits a ``kind:"span"`` record into the same JSONL
journals the telemetry plane already writes — joinable against the
serve tier's ``ring_update`` generation records via the ``gen`` field.

Design rules:

* **Deterministic sampling by key hash.**  A key is traced iff
  ``key_hash % sample == 0`` and its trace id is ``mix32(key_hash)`` — a
  pure function of the key, no RNG, no clock.  Reruns trace the SAME
  requests, and two processes looking at the same batch (the fabric's
  serve mesh, where no header crosses the wire) derive the SAME trace
  and span ids from content alone, so their records join without any
  in-band propagation.
* **Deterministic span ids.**  ``span_id = mix32(trace ^ crc32(leg) ^
  mix32(salt))`` — both endpoints of a fabric leg can compute each
  other's ids from (leg name, round/rank salt), which is how the mesh's
  answer spans parent onto the request spans they answer.
* **Bit-transparency.**  Tracing reads key hashes the planes already
  hold and writes host-side records; owners/generations/digests are
  untouched (pinned by the trace smoke and the serve-mesh digest test).
* **torch-free.**  Imported by ``net/channel.py`` under the frontend
  contract (a frontend process starts no device runtime); numpy + stdlib
  only.

``mix32`` is the murmur3 fmix32 mixer — the same public-domain constants
as ``sim/packbits.mix32`` (the one device-side copy), reimplemented here
in numpy because this module must not import torch.
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from typing import Callable, Optional

import numpy as np

TRACE_HEADER = "ringpop-trace"
HOPS_HEADER = "ringpop-hops"  # owned by forward.batch; read here for spans
DEFAULT_SAMPLE = 256


def mix32(x) -> np.ndarray:
    """murmur3 fmix32 over uint32 (vectorized; same constants as
    ``packbits.mix32`` — keep the two in sync)."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EB_CA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2_AE35)
        x = x ^ (x >> np.uint32(16))
    return x


def trace_id_of(key_hash: int) -> int:
    """The (rerun-stable) trace id of one key hash."""
    return int(mix32(np.uint32(key_hash)))


def salt_of(*parts) -> int:
    """Fold strings/ints into one deterministic uint32 salt — distinct
    spans of the SAME (trace, leg) pair (different dest, rank, round,
    hop level) must get distinct ids, so call sites salt with whatever
    distinguishes them."""
    s = np.uint32(0)
    for p in parts:
        if isinstance(p, str):
            v = np.uint32(zlib.crc32(p.encode()) & 0xFFFFFFFF)
        else:
            v = np.uint32(int(p) & 0xFFFFFFFF)
        s = mix32(s ^ v)
    return int(s)


def span_id_of(
    trace: int, leg: str, salt: int = 0, parent: Optional[int] = None
) -> int:
    """Deterministic span id: both endpoints of a headerless transport
    (the fabric) compute the same value from (trace, leg, salt).  A
    non-None ``parent`` is folded in too, so two spans of the same
    (trace, leg, salt) reached through DIFFERENT upstream paths — e.g.
    a route-forward and a quorum-forward of the same key to the same
    dest at the same hop level — get distinct ids (root spans and the
    remotely-derived mesh request spans have no parent, so their ids
    stay computable from content alone)."""
    return int(
        mix32(
            np.uint32(trace)
            ^ np.uint32(zlib.crc32(leg.encode()) & 0xFFFFFFFF)
            ^ mix32(np.uint32(salt & 0xFFFFFFFF))
            ^ (
                np.uint32(0)
                if parent is None
                else mix32(np.uint32(parent & 0xFFFFFFFF))
            )
        )
    )


def format_header(trace: int, span: int) -> str:
    return f"{trace & 0xFFFFFFFF:08x}:{span & 0xFFFFFFFF:08x}"


def parse_header(headers: Optional[dict]) -> Optional[tuple[int, int]]:
    """``(trace, parent span)`` from a headers dict, or None when the
    request is untraced / the header is malformed (never raises — a
    garbled ops header must not fail a real request)."""
    raw = (headers or {}).get(TRACE_HEADER)
    if not raw or not isinstance(raw, str):
        return None
    parts = raw.split(":")
    if len(parts) != 2:
        return None
    try:
        return int(parts[0], 16) & 0xFFFFFFFF, int(parts[1], 16) & 0xFFFFFFFF
    except ValueError:
        return None


def _hops_of(headers: Optional[dict]) -> int:
    try:
        return int((headers or {}).get(HOPS_HEADER, 0))
    except (TypeError, ValueError):
        return 0


class Span:
    """One in-flight traced leg: ids chosen at ``begin``/``follow``,
    record emitted at ``finish`` (with the measured duration)."""

    __slots__ = ("tracer", "record", "_t0", "_done")

    def __init__(self, tracer: "Tracer", record: dict):
        self.tracer = tracer
        self.record = record
        self._t0 = time.perf_counter()
        self._done = False

    @property
    def trace(self) -> int:
        return self.record["trace"]

    @property
    def span(self) -> int:
        return self.record["span"]

    def header_value(self) -> str:
        """What goes into ``headers[TRACE_HEADER]`` for the downstream
        leg: this span becomes the callee's parent."""
        return format_header(self.trace, self.span)

    def finish(self, **fields) -> dict:
        """Emit the span record (idempotent: the first call wins)."""
        if self._done:
            return self.record
        self._done = True
        rec = self.record
        rec["dur_ms"] = round((time.perf_counter() - self._t0) * 1e3, 3)
        rec.update(fields)
        self.tracer._emit(rec)
        return rec


class Tracer:
    """Span factory + sampling policy + sink fan-out.

    ``sink`` is any callable taking one record dict (a
    :class:`JsonlSink`, ``TelemetryJournal.span``, a
    ``FlightRecorder``, or a :func:`tee` of several).  ``sample`` is
    the 1-in-N key-hash sampling denominator (1 = trace everything —
    tests; 0/None = disabled, every ``begin`` returns None)."""

    def __init__(
        self,
        sink: Callable[[dict], None],
        sample: int = DEFAULT_SAMPLE,
        rank: Optional[int] = None,
    ):
        self.sink = sink
        self.sample = int(sample) if sample else 0
        self.rank = rank
        self.spans_emitted = 0
        self.spans_dropped = 0  # sink failures swallowed (ops never kills)

    # -- sampling -------------------------------------------------------------

    def sample_mask(self, hashes) -> np.ndarray:
        h = np.asarray(hashes, np.uint32)
        if self.sample <= 0:
            return np.zeros(h.shape, bool)
        if self.sample == 1:
            return np.ones(h.shape, bool)
        return (h % np.uint32(self.sample)) == 0

    def sampled_keys(self, hashes) -> np.ndarray:
        h = np.asarray(hashes, np.uint32)
        return h[self.sample_mask(h)]

    # -- span construction ----------------------------------------------------

    def begin(
        self,
        leg: str,
        hashes,
        *,
        parent: Optional[int] = None,
        salt: int = 0,
        hops: int = 0,
        **fields,
    ) -> Optional[Span]:
        """Start a span for a key batch: None unless the batch holds at
        least one sampled key.  ``trace`` is the FIRST sampled key's
        trace id (the reference's one-trace-per-request shape); every
        sampled key's hash + trace id ride the record (``keys`` /
        ``traces``) so any sampled key's chain reconstructs from the
        journal alone."""
        keys = self.sampled_keys(hashes)
        if keys.size == 0:
            return None
        traces = mix32(keys)
        trace = int(traces[0])
        parent = None if parent is None else int(parent) & 0xFFFFFFFF
        record = {
            "kind": "span",
            "leg": leg,
            "trace": trace,
            "span": span_id_of(trace, leg, salt, parent=parent),
            "parent": parent,
            "hops": int(hops),
            "nkeys": int(np.asarray(hashes).shape[0]),
            "keys": [int(k) for k in keys.tolist()],
            "traces": [int(t) for t in traces.tolist()],
            "t": time.time(),
        }
        if self.rank is not None:
            record["rank"] = self.rank
        record.update(fields)
        return Span(self, record)

    def follow(
        self, headers: Optional[dict], leg: str, *, salt: int = 0, **fields
    ) -> Optional[Span]:
        """Continue a trace arriving in ``headers``: None when the
        request is untraced (the upstream made the sampling decision).
        The header's span id becomes this span's parent; ``hops`` is
        read from the ``ringpop-hops`` header the same request carries."""
        parsed = parse_header(headers)
        if parsed is None:
            return None
        trace, parent = parsed
        record = {
            "kind": "span",
            "leg": leg,
            "trace": trace,
            # the parent rides the id: the same endpoint serving the
            # same trace through two different upstream RPCs emits two
            # distinct server/handle spans
            "span": span_id_of(trace, leg, salt, parent=parent),
            "parent": parent,
            "hops": _hops_of(headers),
            "t": time.time(),
        }
        if self.rank is not None:
            record["rank"] = self.rank
        record.update(fields)
        return Span(self, record)

    def _emit(self, record: dict) -> None:
        try:
            self.sink(record)
            self.spans_emitted += 1
        except Exception:
            # the ops plane must never take a request down
            self.spans_dropped += 1


class JsonlSink:
    """A thread-safe JSONL span sink (one record per line) — the
    standalone-file flavor; runs that already hold a
    ``TelemetryJournal`` pass its ``.span`` method instead."""

    def __init__(self, path: str, *, append: bool = False):
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a" if append else "w", buffering=1)

    def __call__(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True)
        with self._lock:
            if not self._f.closed:
                self._f.write(line + "\n")

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def tee(*sinks: Callable[[dict], None]) -> Callable[[dict], None]:
    """Fan one record out to several sinks (journal + flight recorder)."""

    def fan(record: dict) -> None:
        for s in sinks:
            s(record)

    return fan


# record kinds that participate in the span graph: plain spans plus the
# closed-loop pair (obs/rules.py alerts, obs/controller.py actions) —
# each carries trace/span/parent fields, so one chain() walk joins
# alert -> decision -> action -> effect with the forwarding-plane spans
SPAN_KINDS = ("span", "alert", "action")


def chain(records: list[dict], trace: int) -> list[dict]:
    """Reconstruct one trace's span chain from journal records: the
    span-carrying records (``kind`` in :data:`SPAN_KINDS`) whose
    ``trace`` (or ``traces`` list) matches, PLUS their ancestors by
    parent link — a batch-level RPC span records only the batch's
    primary trace, but it carries every rider key, so a rider's chain
    pulls it in through the parent pointer of its own spans.  Ordered
    parent-first (roots first, then children, ties in record order) —
    the join the trace smoke and the acceptance test walk."""
    all_spans = [
        r for r in records
        if r.get("kind") in SPAN_KINDS and "span" in r and "trace" in r
    ]
    by_span: dict[int, dict] = {}
    for s in all_spans:
        by_span.setdefault(s["span"], s)
    keep_ids: set[int] = set()
    for s in all_spans:
        if s.get("trace") == trace or trace in (s.get("traces") or []):
            # the span itself + its ancestor closure
            node, seen = s, set()
            while node is not None and node["span"] not in seen:
                keep_ids.add(node["span"])
                seen.add(node["span"])
                p = node.get("parent")
                node = by_span.get(p) if p is not None else None
    spans = [s for s in all_spans if s["span"] in keep_ids]

    def depth(s: dict) -> int:
        d, seen = 0, {s["span"]}
        p = s.get("parent")
        while p is not None and p in by_span and p not in seen:
            d += 1
            seen.add(p)
            p = by_span[p].get("parent")
        return d

    order = sorted(range(len(spans)), key=lambda i: (depth(spans[i]), i))
    return [spans[i] for i in order]
