"""Distributed communication backend — JSON-RPC over asyncio TCP.

Counterpart of ``ringpop_tpu/net/channel.py``, byte for byte on the wire;
it imports numpy and the standard library only, never ``torch``, so the
serve tier's frontend processes start without a device runtime.

Parity: the reference's TChannel usage (``shared/interfaces.go``,
``shared/shared.go:11-22``).  The reference multiplexes three payload formats
over TChannel subchannels; here one framed JSON transport carries all traffic:

* protocol RPCs (``/protocol/{ping,ping-req,join}`` — json bodies, same
  schemas as ``swim/ping_sender.go:35-40`` etc.),
* forwarded app requests (opaque body + headers, the ``tchannel/raw`` path of
  ``forward/request_sender.go:148-204``),
* admin endpoints.

Design notes, mirroring reference decisions:
* transport-level retries are OFF — ringpop does its own retry/backoff
  (``shared/shared.go:11-22`` disables TChannel retries); a failed call
  surfaces as :class:`CallError` immediately.
* handlers are namespaced by (service, endpoint) — the subchannel equivalent
  (isolated ``ringpop`` subchannel, ``ringpop.go:163``).

Two implementations:
* :class:`TCPChannel` — real sockets on the fabric's RPC plane (r21:
  persistent per-peer links, vectored sends, pooled receive arenas —
  ``parallel/fabric.py`` owns the socket loop; this module owns only the
  frame-dict schema and the JSON/msgpack body encodings), request
  multiplexing by id.
* :class:`LocalChannel`/:class:`LocalNetwork` — in-process loopback with
  first-class fault injection (drop probability, partitions, black holes) —
  the test-harness analog of the reference's RFC-5737 black-hole addresses
  (``swim/test_utils.go:219-227``) but deterministic.
"""

from __future__ import annotations

import asyncio
import inspect
import json
import os
import random
import threading
from typing import Awaitable, Callable, Optional

from ringpop_tpu_torch import logging as logging_mod

_logger = logging_mod.logger("net")

Handler = Callable[[dict, dict], Awaitable[dict]]

# one shared compact encoder for every frame: json.dumps() rebuilds an
# encoder per call and emits spaces after separators; reusing a configured
# JSONEncoder cuts per-frame CPU and bytes on the wire.  ensure_ascii stays
# True: error strings can carry surrogateescape-decoded bytes (e.g. OSError
# filenames) that \\uXXXX-escape fine but crash a strict utf-8 encode.
_encode_frame = json.JSONEncoder(separators=(",", ":")).encode


def _frame_bytes(frame: dict) -> bytes:
    data = _encode_frame(frame).encode("ascii") + b"\n"
    if len(data) > MAX_FRAME_BYTES:
        # fail fast at the SENDER with the actual cause — the receiver would
        # otherwise just drop the connection with a generic close
        raise ValueError(f"frame of {len(data)} bytes exceeds MAX_FRAME_BYTES")
    return data


# -- wire codecs -------------------------------------------------------------
#
# Two frame encodings share one socket format, distinguished by the first
# byte so mixed-codec clusters interoperate (each side *sends* its configured
# codec and *reads* whatever arrives):
#
# * JSON (default): one compact object per line, first byte always ``{`` —
#   the reference-parity wire (the golden corpus in tests/golden pins it).
# * msgpack (opt-in): ``0xC1`` magic + uint32-be length + msgpack payload.
#   0xC1 is the one byte the msgpack spec reserves as "never used", and no
#   JSON frame can start with it.  ~2-3x cheaper to encode/decode than JSON
#   for the small protocol bodies, which is material at forwarding qps.
#
# Select per-channel via ``TCPChannel(codec="msgpack")`` or process-wide via
# ``RINGPOP_TPU_WIRE=msgpack``.

_MSGPACK_MAGIC = b"\xc1"

try:
    import msgpack as _msgpack
except ImportError:  # pragma: no cover - baked into this image, but optional
    _msgpack = None


def _msgpack_frame_bytes(frame: dict) -> bytes:
    payload = _msgpack.packb(frame, use_bin_type=True)
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(f"frame of {len(payload)} bytes exceeds MAX_FRAME_BYTES")
    return _MSGPACK_MAGIC + len(payload).to_bytes(4, "big") + payload


def _encoder_for(codec: str):
    if codec == "msgpack":
        if _msgpack is None:
            raise ValueError("msgpack codec requested but msgpack is not importable")
        return _msgpack_frame_bytes
    if codec == "json":
        return _frame_bytes
    raise ValueError(f"unknown wire codec {codec!r} (expected 'json' or 'msgpack')")


def default_codec() -> str:
    return os.environ.get("RINGPOP_TPU_WIRE", "json")


_warned_msgpack_missing = False

# one frame (either codec) may not exceed this — bounds what a desynced or
# malicious peer can make the reader buffer, while leaving room for the
# biggest legitimate payload (a full-sync membership of a very large host
# cluster).  Also used as the StreamReader limit so long JSON lines work
# (asyncio's 64 KiB default would break large full syncs).
MAX_FRAME_BYTES = 64 * 1024 * 1024

def _decode_frame_body(data) -> Optional[dict]:
    """Decode one frame body of either encoding; None on garbage.

    r21: the fabric RPC plane delimits bodies exactly (one body per
    transport frame), so this is pure decode — no stream reading.  The
    first byte keeps the mixed-codec auto-detection (``{`` = JSON object,
    ``0xC1`` = msgpack magic + uint32-be length) byte-compatible with the
    pre-fold frame format, so the golden corpus and mixed-codec clusters
    are unaffected.  ``data`` may be a memoryview into a pooled receive
    arena — it is only valid for the duration of the call, and both
    decoders materialize fresh objects from it."""
    if len(data) == 0:
        return None
    first = data[0]
    if first == 0x7B:  # "{" — one compact JSON object (+ trailing newline)
        try:
            frame = json.loads(bytes(data))
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        return frame if isinstance(frame, dict) else None
    if first == 0xC1:  # _MSGPACK_MAGIC
        if len(data) < 5:
            return None
        ln = int.from_bytes(bytes(data[1:5]), "big")
        if ln > MAX_FRAME_BYTES or len(data) < 5 + ln:
            return None
        if _msgpack is None:
            # fail LOUDLY: dropping the connection surfaces the
            # misconfiguration to the peer as a hard failure immediately,
            # where skipping frames would blackhole its requests into
            # timeouts (an asymmetric partition SWIM would churn on)
            global _warned_msgpack_missing
            if not _warned_msgpack_missing:
                _warned_msgpack_missing = True
                _logger.warning(
                    "received a msgpack frame but msgpack is not importable "
                    "here; closing connections from msgpack-codec peers"
                )
            return None
        try:
            frame = _msgpack.unpackb(data[5:5 + ln], raw=False)
        except Exception:
            return None
        return frame if isinstance(frame, dict) else None
    return None  # unknown framing — treat as a broken peer


# -- array payload helpers ---------------------------------------------------
#
# The serve tier ships key-hash batches and owner vectors in frame bodies;
# as JSON int lists a 4096-key batch costs ~44 KB and a slow parse.  These
# helpers carry fixed-width little-endian arrays under EITHER codec: raw
# bytes when the frame is msgpack (bin type, zero re-encode), base64 text
# when it is JSON (~1.33x the raw bytes, one C-accelerated decode).  The
# decoder is self-describing on the value type, so mixed-codec
# client/server pairs interoperate like the frames themselves do.
#
# r17 (the unified-transport slice): arrays can additionally ride the
# FABRIC's r15 wire codec (``parallel/fabric.py`` — zero-row/zero-run
# suppression with a measured raw fallback): ``encode_array(...,
# fabric=True)`` wraps the fabric-framed payload in a one-key dict, so
# ``decode_array`` stays self-describing (a dict value IS a fabric
# array; bytes/str stay the plain little-endian lanes) and forwarded
# batches get the serve mesh's codec for free over the SAME endpoints.

_FABRIC_ARRAY_KEY = "_fab"

# r21 (one transport plane): the fabric's codec stack is IMPORTED, not
# re-implemented — channel.py owns no array codec and no socket loop.
# ``frame_array``/``unframe_array`` are the same bytes an array costs
# inside a fabric exchange message; ``RpcEndpoint`` is the persistent-link
# transport TCPChannel rides; ``TransportLedger`` is the merged per-class
# byte ledger.  parallel.fabric is numpy-only (parallel/__init__ imports
# nothing), so this import keeps frontends torch-free (pinned by
# tests/test_torch_serve_transport.py).
from ringpop_tpu_torch.parallel.fabric import (  # noqa: E402
    RpcEndpoint,
    TransportLedger,
    frame_array,
    unframe_array,
)


def encode_array(arr, codec: str, dtype: str = "<u4", fabric: bool = False):
    """A frame-body value for a numeric array under ``codec``.
    ``fabric=True`` routes the payload through the fabric's r15 wire
    codec instead of the plain little-endian lane (dtype/shape become
    self-describing; sparse payloads shrink, dense ones pay only the
    measured-fallback header)."""
    import numpy as _np

    if fabric:
        data = frame_array(_np.asarray(arr, dtype=dtype))
        if codec == "msgpack":
            return {_FABRIC_ARRAY_KEY: data}
        import base64 as _b64

        return {_FABRIC_ARRAY_KEY: _b64.b64encode(data).decode("ascii")}
    data = _np.ascontiguousarray(_np.asarray(arr), dtype=dtype).tobytes()
    if codec == "msgpack":
        return data
    import base64 as _b64

    return _b64.b64encode(data).decode("ascii")


def decode_array(value, dtype: str = "<u4"):
    """Inverse of :func:`encode_array` (accepts every representation —
    plain bytes, base64 text, or the fabric-coded dict; mixed-codec and
    mixed-lane client/server pairs interoperate)."""
    import numpy as _np

    if isinstance(value, dict):
        data = value[_FABRIC_ARRAY_KEY]
        if not isinstance(data, (bytes, bytearray, memoryview)):
            import base64 as _b64

            data = _b64.b64decode(data)
        out = unframe_array(bytes(data))
        # fabric frames carry their own dtype; the caller's expectation
        # reinterprets (two's-complement view, same as the plain lane's
        # frombuffer) rather than converting
        out = out.reshape(-1)
        return out if out.dtype.str == dtype else out.view(_np.dtype(dtype))
    if isinstance(value, (bytes, bytearray, memoryview)):
        data = bytes(value)
    else:
        import base64 as _b64

        data = _b64.b64decode(value)
    return _np.frombuffer(data, dtype=dtype)


# the r17 unified error model: channel failures ARE fabric failures —
# one peer-lifecycle/error family across the serve TCP framing, the shm
# ring and the DCN fabric, so callers branch on FabricTimeout /
# FabricPeerLost semantics regardless of which transport carried the
# request.  The family lives in the import-free leaf
# ringpop_tpu_torch.errors, shared with the shm ring.
from ringpop_tpu_torch.errors import (  # noqa: E402
    FabricError,
    FabricPeerLost,
    FabricTimeout,
)

# span tracing (r20): the header constant + salt helper are torch-free
# (obs/trace.py) — BaseChannel.dispatch emits a transport-level server
# span for requests that arrive with the ringpop-trace header
from ringpop_tpu_torch.obs.trace import TRACE_HEADER, salt_of  # noqa: E402


class CallError(FabricError):
    """A call failed to complete (network error, black hole, timeout)."""


class CallTimeoutError(CallError, FabricTimeout):
    """Nothing answered within the deadline — the channel flavor of a
    silent peer (``FabricTimeout``)."""


class PeerUnreachableError(CallError, FabricPeerLost):
    """Connect refused / connection dropped — the channel flavor of a
    dead peer (``FabricPeerLost``)."""


class RemoteError(CallError):
    """The remote handler raised; carries the remote error message."""


class BaseChannel:
    """Handler registry + dispatch shared by both transports.

    ``tracer`` (an ``obs.trace.Tracer``; default None = off) emits one
    ``kind:"span"`` record per dispatched request that arrived with the
    ``ringpop-trace`` header — the transport-level server leg, between
    the sender's RPC span (its parent, from the header) and whatever the
    handler itself traces.  The sampling decision was the CALLER's: a
    headerless request costs one dict lookup and nothing else."""

    def __init__(self, app: str = ""):
        self.app = app
        self.hostport: str = ""
        self._handlers: dict[tuple[str, str], Handler] = {}
        self.tracer = None

    def register(self, service: str, endpoint: str, handler: Handler) -> None:
        self._handlers[(service, endpoint)] = handler

    def registered_endpoints(self) -> list[tuple[str, str]]:
        return sorted(self._handlers)

    async def dispatch(self, service: str, endpoint: str, body: dict, headers: dict) -> dict:
        handler = self._handlers.get((service, endpoint))
        if handler is None:
            raise RemoteError(f"no handler for {service}::{endpoint}")
        span = None
        if self.tracer is not None and TRACE_HEADER in (headers or {}):
            # the header gate keeps untraced requests at ONE dict lookup
            # (the documented cost) — salt hashing only runs for traced
            # ones.  hops rides the salt so the same endpoint serving
            # the same trace at two hop levels gets two distinct span
            # ids (the parent folded into the id covers the rest).
            span = self.tracer.follow(
                headers, "server",
                salt=salt_of(self.hostport, endpoint,
                             str(headers.get("ringpop-hops", ""))),
                endpoint=endpoint, service=service, hostport=self.hostport,
            )
        try:
            res = handler(body, headers)
            if inspect.isawaitable(res):  # sync handlers are fine too
                res = await res
        except Exception as e:
            if span is not None:
                span.finish(ok=False, error=str(e))
            raise
        if span is not None:
            span.finish(ok=True)
        return res

    async def call(
        self,
        peer: str,
        service: str,
        endpoint: str,
        body: dict,
        headers: Optional[dict] = None,
        timeout: Optional[float] = None,
    ) -> dict:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# TCP transport
# ---------------------------------------------------------------------------


class TCPChannel(BaseChannel):
    """Framed RPC channel on the fabric core (parity: TChannel peer pool,
    ``swim/ping_sender.go:83``).

    r21 (one transport plane): the channel no longer owns a socket loop —
    connection handling, framing, retry surface and the peer registry all
    live in the fabric's :class:`~ringpop_tpu_torch.parallel.fabric.RpcEndpoint`
    (persistent per-link sender/reader threads, vectored sends, pooled
    receive arenas, sticky ``FabricError`` failures).  What remains here
    is the channel's SEMANTIC layer: the request/response frame-dict
    schema, the JSON/msgpack body encodings (unchanged bytes — the golden
    corpus and mixed-codec clusters are unaffected), handler dispatch,
    and the asyncio bridge (replies hop from reader threads onto the
    event loop via ``call_soon_threadsafe``).

    Wire format change vs pre-r21: each body now rides ONE fabric
    transport frame (16-byte ``_HDR``: RPC tag + request id, blob count,
    body length) instead of being self-delimiting on a bare socket.  The
    body bytes themselves are byte-identical.

    r23 latency tiers: plain-sync handlers dispatch directly on the
    link's reader thread (the server-side loop hop survives only for
    coroutine handlers and traced requests), and :meth:`call_sync` gives
    blocking callers inline completion — the reader thread fulfills a
    condition-variable future in place, zero event-loop hops end to end.
    ``flush_us`` enables small-frame coalescing on this endpoint's
    links; ``shm_lane`` negotiates the same-host shm frame lane;
    ``spin_us`` tunes the readers' spin-then-park window.  Every knob
    preserves the body bytes bit-for-bit — lanes move frames, never
    reshape them."""

    def __init__(self, app: str = "", codec: Optional[str] = None,
                 ledger: Optional[TransportLedger] = None, *,
                 flush_us: float = 0.0, shm_lane: Optional[bool] = None,
                 spin_us: Optional[float] = None):
        super().__init__(app)
        self.codec = codec or default_codec()
        self._encode = _encoder_for(self.codec)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # ``ledger`` merges this channel's wire bytes into a shared
        # per-class TransportLedger (class "rpc"); default = private.
        self._ep = RpcEndpoint(
            self._on_request, ledger=ledger, ledger_class="rpc",
            max_body_bytes=MAX_FRAME_BYTES,
            flush_us=flush_us, shm_lane=shm_lane, spin_us=spin_us,
        )
        # legacy frame-level accounting (the pre-r21 keys, body bytes
        # only): kept per-channel so existing journal consumers and the
        # monotone-sampling pins are unmoved.  r23: sync callers and
        # reader-thread dispatch bump these off the loop too, so the
        # counters take a lock (reads stay lock-free int snapshots).
        # The transport-level truth (incl. the 16 B/frame fabric header
        # and the receive side) is ``self.ledger.stats()``.
        self.bytes_sent = 0
        self.frames_sent = 0
        self._legacy_lock = threading.Lock()

    def _count_sent(self, nbytes: int) -> None:
        with self._legacy_lock:
            self.bytes_sent += nbytes
            self.frames_sent += 1

    @property
    def ledger(self) -> TransportLedger:
        return self._ep.ledger

    def wire_stats(self) -> dict:
        """Counter snapshot, shaped like ``Fabric.wire_stats`` so serve
        journals can state per-transport bytes the same way."""
        return {"bytes_sent": self.bytes_sent, "frames_sent": self.frames_sent}

    # -- server side --------------------------------------------------------

    async def listen(self, host: str = "127.0.0.1", port: int = 0) -> str:
        self._loop = asyncio.get_event_loop()
        self.hostport = self._ep.listen(host, port)
        return self.hostport

    def listen_sync(self, host: str = "127.0.0.1", port: int = 0) -> str:
        """Loop-less listen (r23): serve PLAIN-SYNC handlers entirely on
        the links' reader threads — no asyncio anywhere in the request
        path.  Coroutine handlers need :meth:`listen` (they have no loop
        to run on here; their requests would time out at the caller)."""
        self.hostport = self._ep.listen(host, port)
        return self.hostport

    async def close(self) -> None:
        # endpoint close joins link threads (bounded); keep it off the loop
        await asyncio.get_event_loop().run_in_executor(None, self._ep.close)

    def close_sync(self) -> None:
        """Blocking close for loop-less channels (``listen_sync`` /
        pure-``call_sync`` users)."""
        self._ep.close()

    def _on_request(self, link, rid: int, payload) -> None:
        """Inbound request, on the link's reader thread.  ``payload`` is a
        memoryview into the pooled arena — decode NOW.  r23: a plain-sync
        handler (untraced request) dispatches RIGHT HERE and responds
        inline — zero loop hops; coroutine handlers, traced requests and
        missing-handler errors keep the event-loop path."""
        frame = _decode_frame_body(payload)
        if frame is None:
            # garbage breaks only its own connection (pre-r21 reader
            # semantics): raising fails this link, nothing else
            raise FabricError("rpc request body undecodable — dropping the connection")
        handler = self._handlers.get((frame.get("svc", ""), frame.get("ep", "")))
        headers = frame.get("headers") or {}
        if (
            handler is not None
            and not inspect.iscoroutinefunction(handler)
            and (self.tracer is None or TRACE_HEADER not in headers)
        ):
            res = {"id": frame.get("id"), "kind": "res"}
            try:
                body = handler(frame.get("body") or {}, headers)
            except Exception as e:
                res["ok"] = False
                res["err"] = str(e)
            else:
                if inspect.isawaitable(body):
                    # a sync-def handler handed back an awaitable: only
                    # the loop can finish it
                    self._finish_awaitable(frame, link, rid, body)
                    return
                res["ok"] = True
                res["body"] = body
            self._respond(link, rid, res)
            return
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        try:
            asyncio.run_coroutine_threadsafe(self._serve_frame(frame, link, rid), loop)
        except RuntimeError:
            pass  # loop shut down mid-flight

    def _finish_awaitable(self, frame: dict, link, rid: int, body) -> None:
        loop = self._loop
        if loop is None or loop.is_closed():
            return

        async def finish() -> None:
            res = {"id": frame.get("id"), "kind": "res"}
            try:
                res["body"] = await body
                res["ok"] = True
            except Exception as e:
                res["ok"] = False
                res["err"] = str(e)
            self._respond(link, rid, res)

        try:
            asyncio.run_coroutine_threadsafe(finish(), loop)
        except RuntimeError:
            pass

    async def _serve_frame(self, frame: dict, link, rid: int) -> None:
        res = {"id": frame.get("id"), "kind": "res"}
        try:
            body = await self.dispatch(
                frame.get("svc", ""), frame.get("ep", ""), frame.get("body") or {}, frame.get("headers") or {}
            )
            res["ok"] = True
            res["body"] = body
        except Exception as e:  # handler error propagates as app error
            res["ok"] = False
            res["err"] = str(e)
        self._respond(link, rid, res)

    def _respond(self, link, rid: int, res: dict) -> None:
        try:
            payload = self._encode(res)
        except Exception as e:
            # an unencodable handler result (or error string with surrogate
            # bytes under msgpack) must still produce a response — the JSON
            # encoder with ensure_ascii handles any str; never hang the caller.
            # The id itself may be the unencodable part (a msgpack peer can
            # send bytes ids): only pass through JSON-safe ids.
            rid_body = res.get("id")
            if not isinstance(rid_body, (str, int, float)):
                rid_body = None
            payload = _frame_bytes(
                {"id": rid_body, "kind": "res", "ok": False,
                 "err": f"response encode failed: {type(e).__name__}"}
            )
        # Count BEFORE handing the frame to the link: once respond() writes
        # the socket the client can observe the reply and read wire_stats()
        # from another thread — counting after the write races that read
        # (the ledger counts at write time and would show one more frame).
        self._count_sent(len(payload))
        link.respond(rid, payload)

    # -- client side --------------------------------------------------------

    async def _get_link(self, peer: str):
        link = self._ep.get(peer)
        if link is not None:
            return link
        loop = asyncio.get_event_loop()
        try:
            # blocking dial off the loop; the endpoint caches one live
            # link per peer (dial races resolve to the established one)
            return await loop.run_in_executor(None, self._ep.connect, peer)
        except FabricPeerLost as e:
            raise PeerUnreachableError(str(e)) from e

    async def call(self, peer, service, endpoint, body, headers=None, timeout=None) -> dict:
        link = await self._get_link(peer)
        rid = link.alloc_id()
        frame = {
            "id": rid,
            "kind": "req",
            "svc": service,
            "ep": endpoint,
            "body": body,
            "headers": headers or {},
        }
        try:
            encoded = self._encode(frame)
        except Exception as e:
            raise CallError(f"encode request for {peer}: {type(e).__name__}: {e}") from e
        loop = asyncio.get_event_loop()
        fut: asyncio.Future = loop.create_future()

        def _post(setter, value):
            def apply():
                if not fut.done():
                    setter(value)
            try:
                loop.call_soon_threadsafe(apply)
            except RuntimeError:
                pass  # loop already closed; nobody is awaiting

        def on_reply(payload, lane="tcp"):
            # reader-thread callback: payload is an arena memoryview (or
            # the link's sticky error) — decode here, resolve on the loop
            if isinstance(payload, BaseException):
                err = payload if isinstance(payload, CallError) else (
                    PeerUnreachableError(str(payload)))
                if err is not payload and err.__cause__ is None:
                    err.__cause__ = payload
                _post(fut.set_exception, err)
                return
            res = _decode_frame_body(payload)
            if res is None:
                _post(fut.set_exception,
                      PeerUnreachableError(f"undecodable response frame from {peer}"))
                raise FabricError("rpc response undecodable — dropping the connection")
            if res.get("ok"):
                _post(fut.set_result, res.get("body") or {})
            else:
                _post(fut.set_exception, RemoteError(res.get("err", "remote error")))

        link.request(rid, encoded, on_reply)
        self._count_sent(len(encoded))
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            link.forget(rid)
            raise CallTimeoutError(f"call {peer} {endpoint} timed out after {timeout}s")

    def call_sync(self, peer, service, endpoint, body, headers=None,
                  timeout=None, urgent=False) -> dict:
        """Blocking call with INLINE COMPLETION (r23): the reply is
        fulfilled directly on the link's reader thread via an Event —
        no event loop in the round trip at all.  Pair with a sync
        handler on the far side (or ``listen_sync``) for the zero-hop
        path: caller-thread write → reader-thread wake.

        ``urgent=True`` bypasses small-frame coalescing on channels
        built with ``flush_us > 0`` (the probe escape hatch).  Must be
        called OFF the event loop (it blocks)."""
        try:
            link = self._ep.connect(peer)
        except FabricPeerLost as e:
            raise PeerUnreachableError(str(e)) from e
        rid = link.alloc_id()
        frame = {
            "id": rid,
            "kind": "req",
            "svc": service,
            "ep": endpoint,
            "body": body,
            "headers": headers or {},
        }
        try:
            encoded = self._encode(frame)
        except Exception as e:
            raise CallError(f"encode request for {peer}: {type(e).__name__}: {e}") from e
        done = threading.Event()
        slot = [None, None]  # [result_body, error]

        def on_reply(payload, lane="tcp"):
            # reader thread (tcp) or shm-lane reader thread: decode and
            # fulfil right here — the waiter wakes on a futex, not a loop
            if isinstance(payload, BaseException):
                err = payload if isinstance(payload, CallError) else (
                    PeerUnreachableError(str(payload)))
                if err is not payload and err.__cause__ is None:
                    err.__cause__ = payload
                slot[1] = err
                done.set()
                return
            res = _decode_frame_body(payload)
            if res is None:
                slot[1] = PeerUnreachableError(
                    f"undecodable response frame from {peer}")
                done.set()
                raise FabricError("rpc response undecodable — dropping the connection")
            if res.get("ok"):
                slot[0] = res.get("body") or {}
            else:
                slot[1] = RemoteError(res.get("err", "remote error"))
            self.ledger.add("rpc", lane=lane, inline_completions=1)
            done.set()

        link.request(rid, encoded, on_reply, urgent=urgent)
        self._count_sent(len(encoded))
        if not done.wait(timeout):
            link.forget(rid)
            raise CallTimeoutError(f"call {peer} {endpoint} timed out after {timeout}s")
        if slot[1] is not None:
            raise slot[1]
        return slot[0] if slot[0] is not None else {}


# ---------------------------------------------------------------------------
# In-process transport with fault injection
# ---------------------------------------------------------------------------


class LocalNetwork:
    """Registry of in-process channels + fault model.

    Faults are first-class (BASELINE configs list packet-loss and partition
    scenarios): per-pair partitions, global drop probability, and black-hole
    addresses that swallow traffic (timeout) instead of refusing it."""

    def __init__(self, seed: int = 0):
        self.channels: dict[str, "LocalChannel"] = {}
        self.rng = random.Random(seed)
        self.drop_rate = 0.0
        self._partitions: list[set[str]] = []  # node -> group via membership
        self._black_holes: set[str] = set()
        self.latency: float = 0.0  # injected per-call delay (seconds)

    def register(self, channel: "LocalChannel") -> None:
        self.channels[channel.hostport] = channel

    def unregister(self, hostport: str) -> None:
        self.channels.pop(hostport, None)

    # -- fault injection ----------------------------------------------------

    def partition(self, *groups: list[str]) -> None:
        """Split the network: nodes in different groups cannot talk."""
        self._partitions = [set(g) for g in groups]

    def heal_partition(self) -> None:
        self._partitions = []

    def black_hole(self, *hostports: str) -> None:
        self._black_holes.update(hostports)

    def unblack_hole(self, *hostports: str) -> None:
        self._black_holes.difference_update(hostports)

    def _connected(self, a: str, b: str) -> bool:
        if not self._partitions:
            return True
        ga = next((i for i, g in enumerate(self._partitions) if a in g), None)
        gb = next((i for i, g in enumerate(self._partitions) if b in g), None)
        # nodes not named in any group can talk to everyone
        return ga is None or gb is None or ga == gb

    async def deliver(
        self, src: str, dst: str, service: str, endpoint: str, body: dict, headers: dict, timeout: Optional[float]
    ) -> dict:
        if self.latency:
            await asyncio.sleep(self.latency)
        if dst in self._black_holes or src in self._black_holes or not self._connected(src, dst):
            # black hole: behave like a timeout, not a refusal
            await asyncio.sleep(min(timeout or 0.01, 0.01))
            raise CallTimeoutError(f"{src}->{dst} black-holed")
        if self.drop_rate and self.rng.random() < self.drop_rate:
            await asyncio.sleep(min(timeout or 0.01, 0.01))
            raise CallTimeoutError(f"{src}->{dst} dropped")
        target = self.channels.get(dst)
        if target is None:
            raise PeerUnreachableError(f"connect {dst}: connection refused")
        try:
            res = await target.dispatch(
                service, endpoint, json.loads(_encode_frame(body)), dict(headers)
            )
        except CallError:
            raise
        except Exception as e:  # remote handler error, as the TCP path reports it
            raise RemoteError(str(e)) from e
        return json.loads(_encode_frame(res))


class LocalChannel(BaseChannel):
    """In-process channel attached to a LocalNetwork."""

    def __init__(self, network: LocalNetwork, hostport: str, app: str = ""):
        super().__init__(app)
        self.network = network
        self.hostport = hostport
        network.register(self)

    async def listen(self, host: str = "", port: int = 0) -> str:
        return self.hostport

    async def close(self) -> None:
        self.network.unregister(self.hostport)

    async def call(self, peer, service, endpoint, body, headers=None, timeout=None) -> dict:
        return await self.network.deliver(
            self.hostport, peer, service, endpoint, body, headers or {}, timeout
        )
