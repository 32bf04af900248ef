"""The fabric's RPC and codec half: the transport plane the serve tier's
channel rides (counterpart of ``ringpop_tpu/parallel/fabric.py``).

This module holds what ``net/channel.py`` and ``serve/shm.py`` import, byte
for byte as the JAX package has it:

* the array wire codec — zero-row suppression (``ROWS``: a bitmap of
  nonzero rows + the packed payload), zero-word run suppression (``RUNS``)
  and a MEASURED raw fallback (an encoding that does not strictly shrink
  the payload is never sent): ``encode_rows``, ``encode_array``,
  ``decode_array``, ``frame_array``, ``unframe_array``;
* ``TransportLedger``, the merged per-class byte ledger, and the fabric
  failure hooks;
* the RPC plane: ``RpcEndpoint`` / ``RpcLink`` — persistent per-link
  sender and reader threads, vectored sends, pooled receive arenas,
  sticky ``FabricError`` failures — and the same-host shared-memory frame
  lane ``_RpcShmLane``.

and the host-bridged DCN mesh the multi-host delta engine
(``sim/delta_multihost``) rides, as the JAX package has it:

* rendezvous — every rank publishes ``<ns>/addr/<rank>`` in a key-value
  store (``LocalKV`` for threads of one process; ``DistributedKV``, a
  ``torch.distributed.TCPStore`` client, for OS processes) and dials its
  lower-ranked peers once; bulk data never rides the store;
* data — ``Fabric``: length-framed numpy messages over the peer sockets,
  tagged by the caller, drained by per-peer persistent sender threads
  while per-peer receiver threads demux tagged expectations in FIFO order;
  ``exchange_async`` returns an ``ExchangeHandle`` (``exchange`` is its
  ``wait()``), ``allgather`` runs the cyclic full mesh or the swing
  recursive doubling, and byte accounting is split into wire and raw
  (codec-off) bytes;
* schedules — the cyclic window planner ``plan_window`` and the
  distance-halving relay plan ``plan_window_swing``.

The module imports numpy and the standard library only — never ``torch``
(``DistributedKV`` imports ``torch.distributed`` when it is built) — so the
serve tier's frontend processes import it without a device runtime.
"""
from __future__ import annotations

import base64
import functools
import json
import os
import queue
import socket
import struct
import tempfile
import threading
import time
from datetime import timedelta
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np

_HDR = struct.Struct(">IIQ")  # tag, n_arrays, total payload bytes
# per-array header: codec byte, dtype-str len, ndim, ENCODED payload bytes
# (dtype str + ">u8" shape words follow; then the encoded payload)
_AHDR = struct.Struct(">BIIQ")

# -- wire codec ---------------------------------------------------------------

CODEC_RAW = 0  # payload = a.tobytes()
CODEC_ROWS = 1  # ">I" nnz-rows + LSB-first row bitmap + nonzero rows packed
CODEC_RUNS = 2  # ">I" n-runs + "<u4" starts + "<u4" lens + nonzero u32 words
CODEC_XOR = 3  # ">II" epoch, inner codec + inner payload of prev-XOR diff

CODEC_NAMES = {CODEC_RAW: "raw", CODEC_ROWS: "rows",
               CODEC_RUNS: "runs", CODEC_XOR: "xor"}


# the error family lives in the import-free leaf ``ringpop_tpu_torch.errors``
# (shared with the channel and the shm ring); re-exported here under the
# import path the JAX package's callers use
from ringpop_tpu_torch.errors import (  # noqa: F401  (re-export)
    FabricDesync,
    FabricError,
    FabricPeerLost,
    FabricTimeout,
)


class Encoded(NamedTuple):
    """A pre-encoded wire array (codec already applied).  Callers that
    hold send-side structure the encoder would otherwise recompute — the
    multihost engine's DEVICE-computed nonzero-row summaries — hand the
    fabric one of these instead of an ndarray; ``decode_array`` cannot
    tell the difference."""

    codec: int
    dtype: np.dtype
    shape: tuple
    payload: bytes
    raw_nbytes: int


def _bitmap_pack(mask: np.ndarray) -> bytes:
    """bool[rows] -> ceil(rows/8) LSB-first bytes (bit i of byte j is
    row 8j+i) — the byte order ``packbits.pack_bool``'s little-endian
    uint32 word view produces, so device-packed masks are wire-identical
    to host-packed ones."""
    return np.packbits(mask, bitorder="little").tobytes()


def _bitmap_unpack(buf: bytes, rows: int) -> np.ndarray:
    return np.unpackbits(
        np.frombuffer(buf, np.uint8), count=rows, bitorder="little"
    ).astype(bool)


def rows_wire_size(rows: int, nnz: int, row_nbytes: int) -> int:
    """Encoded-payload size of a ROWS encoding — callers with a
    device-side nonzero count use this to decide BEFORE transferring."""
    return 4 + (rows + 7) // 8 + nnz * row_nbytes


def encode_rows(
    mask: np.ndarray, rows_payload: np.ndarray, shape: tuple, dtype
) -> Encoded:
    """Build a ROWS encoding from an externally computed nonzero-row
    mask + already-compacted nonzero rows (the device-sliced hot path).
    The caller is responsible for having checked ``rows_wire_size``
    against the raw size — this constructor encodes unconditionally."""
    dtype = np.dtype(dtype)
    raw_nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    nnz = int(rows_payload.shape[0])
    payload = (
        struct.pack(">I", nnz)
        + _bitmap_pack(np.asarray(mask, bool))
        + np.ascontiguousarray(rows_payload).tobytes()
    )
    return Encoded(CODEC_ROWS, dtype, tuple(shape), payload, raw_nbytes)


def _rows_encode(a: np.ndarray) -> Optional[bytes]:
    """Zero-row suppression; None when it would not strictly shrink.
    The row mask tests the BYTE view, not values — float -0.0 is
    value-equal to zero but bit-distinct, and the decode contract is
    bit-exactness (``a`` is contiguous: encode_array guarantees it)."""
    if a.ndim < 2 or a.shape[0] < 2 or a.size == 0:
        return None
    flat = a.reshape(a.shape[0], -1)
    mask = (flat.view(np.uint8) != 0).any(axis=1)
    nnz = int(mask.sum())
    row_nbytes = a.nbytes // a.shape[0]
    if rows_wire_size(a.shape[0], nnz, row_nbytes) >= a.nbytes:
        return None
    return struct.pack(">I", nnz) + _bitmap_pack(mask) + flat[mask].tobytes()


def _rows_decode(payload: bytes, shape: tuple, dtype: np.dtype) -> np.ndarray:
    (nnz,) = struct.unpack_from(">I", payload, 0)
    nb = 4 + (shape[0] + 7) // 8
    mask = _bitmap_unpack(payload[4:nb], shape[0])
    if int(mask.sum()) != nnz:
        raise FabricError(
            f"ROWS bitmap popcount {int(mask.sum())} != header nnz {nnz} — "
            "corrupt frame"
        )
    out = np.zeros(shape, dtype)
    out[mask] = np.frombuffer(payload, dtype, offset=nb).reshape(
        (nnz,) + tuple(shape[1:])
    )
    return out


def _runs_encode(a: np.ndarray) -> Optional[bytes]:
    """Zero-WORD run suppression over the uint32 view; None when the
    dtype does not view as whole words or it would not strictly shrink.
    ``a`` must be C-contiguous (``encode_array`` guarantees it) — the
    word view and the cheap-reject count are copy-free, so a dense plane
    costs ONE pass here, not the full run detection."""
    if a.nbytes % 4 or a.nbytes == 0:
        return None
    w = a.reshape(-1).view(np.uint32)
    nz = w != 0
    nnz_words = int(np.count_nonzero(nz))
    if 4 + 8 + 4 * nnz_words >= a.nbytes:
        return None  # even a single run cannot shrink this payload
    edges = np.flatnonzero(np.diff(np.concatenate(([False], nz, [False]))))
    starts, ends = edges[0::2], edges[1::2]
    size = 4 + 8 * len(starts) + 4 * nnz_words
    if size >= a.nbytes:
        return None
    return (
        struct.pack(">I", len(starts))
        + starts.astype("<u4").tobytes()
        + (ends - starts).astype("<u4").tobytes()
        + w[nz].tobytes()
    )


def _runs_decode(payload: bytes, nbytes: int) -> np.ndarray:
    """-> the flat uint32 word view (caller reshapes/reviews)."""
    (nruns,) = struct.unpack_from(">I", payload, 0)
    starts = np.frombuffer(payload, "<u4", count=nruns, offset=4).astype(np.int64)
    lens = np.frombuffer(payload, "<u4", count=nruns, offset=4 + 4 * nruns).astype(
        np.int64
    )
    words = np.frombuffer(payload, np.uint32, offset=4 + 8 * nruns)
    out = np.zeros(nbytes // 4, np.uint32)
    if nruns:
        tot = int(lens.sum())
        off = np.arange(tot, dtype=np.int64) - np.repeat(
            np.cumsum(lens) - lens, lens
        )
        out[np.repeat(starts, lens) + off] = words
    return out


def encode_array(
    a: np.ndarray,
    prev: Optional[bytes] = None,
    epoch: int = 0,
    rows: bool = True,
) -> Encoded:
    """Best strictly-smaller encoding of ``a`` — RAW when nothing pays
    (the measured fallback).  ``prev`` (the previous payload bytes on
    this stream, same shape/dtype — the caller guarantees it was
    recorded under ``epoch``) additionally offers the XOR-delta.
    ``rows=False`` skips the ROWS attempt — for callers that already
    know the nonzero-row count (the engine's device-side summary) and
    would otherwise pay a redundant full host scan per dense piece."""
    a = np.ascontiguousarray(a)
    cands: list[tuple[int, int, bytes]] = [(a.nbytes, CODEC_RAW, b"")]
    rows_payload = _rows_encode(a) if rows else None
    if rows_payload is not None:
        cands.append((len(rows_payload), CODEC_ROWS, rows_payload))
    runs = _runs_encode(a)
    if runs is not None:
        cands.append((len(runs), CODEC_RUNS, runs))
    if prev is not None and len(prev) == a.nbytes and a.nbytes:
        diff = np.bitwise_xor(
            a.reshape(-1).view(np.uint8),
            np.frombuffer(prev, np.uint8),
        )
        # only a RUNS-compressed diff can undercut raw (an inner-RAW
        # XOR payload is raw + 8 header bytes by construction), so no
        # RUNS win means no XOR candidate; decode_array still accepts
        # an inner-RAW frame for wire-format completeness
        inner = _runs_encode(diff)
        if inner is not None:
            xor_payload = struct.pack(">II", epoch & 0xFFFFFFFF, CODEC_RUNS) + inner
            if len(xor_payload) < a.nbytes:
                cands.append((len(xor_payload), CODEC_XOR, xor_payload))
    size, codec, payload = min(cands, key=lambda c: (c[0], c[1]))
    if codec == CODEC_RAW:
        payload = a.tobytes()
    return Encoded(codec, a.dtype, a.shape, payload, a.nbytes)


def decode_array(
    codec: int,
    dtype: np.dtype,
    shape: tuple,
    payload: bytes,
    prev: Optional[bytes] = None,
    epoch: int = 0,
) -> np.ndarray:
    """Exact inverse of every encoding.  XOR requires the previous
    payload on the stream AND a matching epoch word — a mismatch means
    one side missed a codec reset (snapshot restore / peer change) and
    MUST fail loudly rather than decode garbage."""
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    if codec == CODEC_RAW:
        return np.frombuffer(payload, dtype, count=-1).reshape(shape).copy()
    if codec == CODEC_ROWS:
        return _rows_decode(payload, tuple(shape), np.dtype(dtype))
    if codec == CODEC_RUNS:
        words = _runs_decode(payload, nbytes)
        return np.frombuffer(words.tobytes(), dtype).reshape(shape).copy()
    if codec == CODEC_XOR:
        got_epoch, inner_codec = struct.unpack_from(">II", payload, 0)
        if prev is None or got_epoch != (epoch & 0xFFFFFFFF):
            raise FabricError(
                f"codec epoch desync: XOR frame carries epoch {got_epoch} but "
                f"this rank is at epoch {epoch & 0xFFFFFFFF} with "
                f"{'no' if prev is None else 'a'} previous payload — a codec "
                "reset (snapshot restore / peer-count change) was missed on "
                "one side"
            )
        inner = payload[8:]
        if inner_codec == CODEC_RUNS:
            diff = _runs_decode(inner, nbytes).tobytes()
        else:
            diff = inner
        raw = np.bitwise_xor(
            np.frombuffer(diff, np.uint8),
            np.frombuffer(prev, np.uint8),
        ).tobytes()
        return np.frombuffer(raw, dtype).reshape(shape).copy()
    raise FabricError(f"unknown wire codec byte {codec}")


def frame_array(a: np.ndarray) -> bytes:
    """One array as a self-contained fabric frame: the per-array header
    (codec byte, dtype, shape) + best-encoding payload — byte-identical
    to what the same array costs inside an exchange message.  The r17
    unified-transport hook: ``net.channel`` rides the r15 codec through
    this for frame-body array values."""
    enc = encode_array(np.ascontiguousarray(a))
    dt = enc.dtype.str.encode()
    shape = np.asarray(enc.shape, ">u8").tobytes()
    return (
        _AHDR.pack(enc.codec, len(dt), len(enc.shape), len(enc.payload))
        + dt + shape + enc.payload
    )


def unframe_array(data: bytes) -> np.ndarray:
    """Exact inverse of :func:`frame_array`."""
    codec, dtl, ndim, nbytes = _AHDR.unpack_from(data, 0)
    off = _AHDR.size
    dt = data[off : off + dtl].decode()
    off += dtl
    shape = tuple(np.frombuffer(data, ">u8", count=ndim, offset=off).astype(int))
    off += 8 * ndim
    return decode_array(codec, np.dtype(dt), shape, data[off : off + nbytes])



def _send_exact(sock: socket.socket, data) -> None:
    sock.sendall(data)


# Linux IOV_MAX is 1024; staying under it keeps every sendmsg call a
# single syscall attempt instead of an EINVAL surprise on huge rounds
_IOV_CHUNK = 512


def _send_parts(sock: socket.socket, parts: Sequence) -> None:
    """Vectored send of a framed message: header + per-array metadata +
    payload buffers go to the kernel as ONE iovec (``sendmsg``) instead
    of being ``+``-concatenated into a fresh wire-sized bytes object —
    the send half of the r21 zero-copy contract.  Partial sends advance
    through memoryviews; no payload bytes are ever copied host-side."""
    bufs = [memoryview(p) for p in parts if len(p)]
    while bufs:
        sent = sock.sendmsg(bufs[:_IOV_CHUNK])
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if sent:
            bufs[0] = bufs[0][sent:]


class TransportLedger:
    """The ONE merged byte ledger of the unified transport plane (r21).

    Every transport class — the fabric's exchange streams (``exchange``),
    the RPC request/response tag family the channel rides (``rpc``), the
    obs side-channel fabric (``obs``), the serve shm ring (``shm``) —
    accounts into the same ledger under its class key, so a run can state
    its total wire traffic AND the per-tag-family split from one
    snapshot.  ``copy_bytes`` counts payload bytes that took an
    intermediate host copy on a registered-buffer path (the shm slot →
    fused dispatch hand-off); the zero-copy acceptance bar is that it
    reads 0 there — proven by the transport smoke, not claimed.

    Per-class sums are defined to equal the legacy per-transport
    counters (``Fabric.wire_stats``, the channel's ``wire_stats``, the
    shm server's slot accounting) on identical traffic — the r21
    migration contract pinned by test and by ``make transport-smoke``.

    r23 adds a per-LANE dimension under every class: the RPC plane can
    carry a frame over TCP or over the same-host shm frame lane, and the
    serve ring is a shm lane by construction.  ``add(..., lane=...)``
    attributes each delta to one lane; a class row in ``stats()`` is the
    field-wise SUM of its lanes (so every pre-r23 reconciliation holds
    unchanged) plus a ``"lanes"`` sub-dict with the split.  Two latency-
    tier liveness counters ride along: ``inline_completions`` (replies
    fulfilled directly on a reader thread for a blocked sync caller —
    zero event-loop hops) and ``coalesced_frames`` (frames that shared
    one ``sendmsg`` with at least one other frame).
    """

    FIELDS = (
        "bytes_sent", "bytes_recv", "raw_bytes_sent", "raw_bytes_recv",
        "frames_sent", "frames_recv", "copy_bytes",
        "inline_completions", "coalesced_frames",
    )
    LANES = ("tcp", "shm")

    def __init__(self):
        self._lock = threading.Lock()
        # class -> lane -> field row
        self._classes: dict[str, dict[str, dict[str, int]]] = {}

    def add(self, klass: str, lane: str = "tcp", **deltas: int) -> None:
        with self._lock:
            lanes = self._classes.setdefault(klass, {})
            row = lanes.setdefault(lane, {f: 0 for f in self.FIELDS})
            for k, v in deltas.items():
                row[k] += int(v)

    def stats(self) -> dict:
        """Snapshot: ``{"classes": {class: {field: n, "lanes": {lane:
        {field: n}}}}, "total": {field: n}, "copy_bytes": n}`` — a class
        row's fields are the sums of its lanes; ``copy_bytes`` is lifted
        to the top level because it is the zero-copy certificate, not a
        traffic counter."""
        with self._lock:
            snap = {
                k: {ln: dict(r) for ln, r in sorted(lanes.items())}
                for k, lanes in sorted(self._classes.items())
            }
        classes: dict[str, dict] = {}
        for k, lanes in snap.items():
            row: dict = {
                f: sum(r[f] for r in lanes.values()) for f in self.FIELDS
            }
            row["lanes"] = lanes
            classes[k] = row
        total = {f: sum(v[f] for v in classes.values()) for f in self.FIELDS}
        return {
            "classes": classes,
            "total": total,
            "copy_bytes": total["copy_bytes"],
        }






# -- failure hooks (the flight-recorder seam, r20) ----------------------------
#
# Observers of fabric-level failures: every callable registered here is
# invoked (best-effort, exceptions swallowed — a diagnostic hook must
# never mask the original failure) with the typed error at the moment a
# link goes sticky or a round's errors aggregate into a raise.  The
# obs-plane FlightRecorder registers here to dump a rank's last seconds
# the instant its peer vanishes (FabricPeerLost) or wedges
# (FabricTimeout).

_FAILURE_HOOKS: list = []


def add_failure_hook(fn) -> None:
    """Register ``fn(err: BaseException)`` to observe fabric failures."""
    _FAILURE_HOOKS.append(fn)


def remove_failure_hook(fn) -> None:
    try:
        _FAILURE_HOOKS.remove(fn)
    except ValueError:
        pass


def _notify_failure(err: BaseException) -> None:
    for fn in list(_FAILURE_HOOKS):
        try:
            fn(err)
        except Exception:
            pass


def _aggregate_raise(errs: Sequence[BaseException], notify: bool = True) -> None:
    """Raise ``errs[0]`` with every OTHER error attached: chained via
    ``__context__`` (so one traceback shows the whole multi-peer outage)
    and collected on ``peer_errors`` for programmatic access.  Before r16
    a round that failed on several sender threads raised only ``errs[0]``
    and silently dropped the rest.  ``notify=False`` (a
    ``notify_failures=False`` fabric) skips the failure hooks."""
    if not errs:
        return
    if notify:
        for e in errs:
            _notify_failure(e)
    primary = errs[0]
    rest = [e for e in errs[1:] if e is not primary]
    node = primary
    seen = {id(primary)}
    for e in rest:
        while node.__context__ is not None and id(node.__context__) not in seen:
            node = node.__context__
            seen.add(id(node))
        if id(e) not in seen:
            node.__context__ = e
            seen.add(id(e))
            node = e
    primary.peer_errors = tuple([primary, *rest])  # type: ignore[attr-defined]
    raise primary



class _AllocCounter:
    """Receive-buffer allocation counter (r21 satellite): the pooled
    arena makes per-frame allocation a regression, so tests pin that a
    steady-state exchange stream allocates O(1), not O(frames)."""

    __slots__ = ("n", "_lock")

    def __init__(self):
        self.n = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        with self._lock:
            self.n += 1


RECV_ALLOCS = _AllocCounter()


def _recv_exact(
    sock: socket.socket, n: int, buf: Optional[bytearray] = None
) -> memoryview:
    """Read exactly ``n`` bytes into ``buf`` (a caller-pooled arena,
    reused across frames) and return a sized read view.  The view is
    valid only until the next call that reuses the same arena — decoders
    must copy anything that outlives the frame (``decode_array`` already
    materializes fresh arrays).  ``buf=None`` allocates, and every
    allocation (fresh or arena-growth, which the caller does before
    passing a bigger buf) bumps ``RECV_ALLOCS`` so the per-frame-alloc
    regression is pinnable."""
    if buf is None or len(buf) < n:
        RECV_ALLOCS.bump()
        buf = bytearray(n)
    view = memoryview(buf)[:n]
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise FabricPeerLost("fabric peer closed the connection")
        got += r
    return view





# -- the RPC plane (r21): request/response tag family on the fabric core -----
#
# The channel's TCP transport (net/channel.py) used to own its OWN asyncio
# socket loop, framing, retry/timeout and peer registry.  r21 folds all of
# that onto the fabric's persistent-link machinery: an RPC frame is a
# fabric ``_HDR`` frame whose tag carries a kind byte + a 24-bit request
# id, and whose payload is ONE opaque body blob (the channel's
# self-describing JSON/msgpack frame bytes — the body encodings are
# unchanged so mixed-codec endpoints keep interoperating).  Each
# connection is an :class:`RpcLink`: a persistent sender thread draining
# vectored frames and a reader thread demuxing request vs response frames
# by tag kind — the exact shape of ``_PeerLink``, with the tagged-FIFO
# expectation queue replaced by an id-keyed pending table (requests are
# unsolicited, so the demux is a map, not a queue).  Errors are the
# fabric family and sticky per link; bytes account into the merged
# :class:`TransportLedger` under class ``"rpc"``.

TAG_RPC_REQ = 0x51 << 24  # | (id & _RPC_ID_MASK)
TAG_RPC_RES = 0x52 << 24
TAG_RPC_CTL = 0x53 << 24  # control: shm-lane negotiation (offer/ack/nak)
_RPC_KIND_MASK = 0xFF000000
_RPC_ID_MASK = 0x00FFFFFF

# one RPC body may not exceed this — same bound (and same rationale) as
# the channel's MAX_FRAME_BYTES: caps what a desynced or malicious peer
# can make the reader arena hold
MAX_RPC_BODY_BYTES = 64 * 1024 * 1024

# -- r23 latency tiers --------------------------------------------------------
#
# Reader spin window: after link activity the reader busy-polls (non-
# blocking recv attempts, each releasing the GIL at the syscall) for this
# long before parking in blocking recv — the serve shm ring's post-
# activity burst discipline applied to the TCP readers.  On request/
# response ping-pong the next frame lands inside the window, so the
# steady-state round trip never pays a kernel thread wakeup.  Small by
# design: an idle link burns at most one window per received frame.
#
# The DEFAULT is core-count-aware: a spinning reader only wins when the
# thread that will produce the next frame has its own core to run on.
# On 1-2 core containers the spinner STEALS the producer's core (and its
# GIL slice) and measurably inflates RTT — measured on the 1-core CI
# box: 66 µs p50 at spin=0 vs 195 µs at spin=60.  Explicit ``spin_us``
# or the env var always wins over the heuristic.
def _default_spin_us() -> float:
    env = os.environ.get("RINGPOP_TPU_RPC_SPIN_US")
    if env is not None:
        return float(env)
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # pragma: no cover - non-linux
        cores = os.cpu_count() or 1
    return 60.0 if cores >= 4 else 0.0

# frames at or under this (header included) are "small": they may wait up
# to the endpoint's ``flush_us`` for company and flush as ONE sendmsg
_COALESCE_MAX_FRAME = 4096 + _HDR.size
# bound one coalesced sendmsg batch (stays under the _IOV_CHUNK split)
_COALESCE_MAX_FRAMES = 128

# sender-queue sentinel: cut any open coalescing window NOW (the
# explicit-flush escape hatch for latency-critical probes)
_FLUSH = object()


class _RpcShmLane:
    """Same-host frame lane for one :class:`RpcLink` (r23).

    One shared segment holds 8 control words plus two SPSC frame rings
    (creator→attacher and attacher→creator), each ``slots`` slots of 4
    uint32 header words (``seq``, ``ack``, ``len``, reserved) and
    ``slot_bytes`` of payload.  The slot protocol is ``serve/shm.py``'s
    seq-word discipline generalized to opaque fabric frames: the writer
    fills the payload, then publishes ``seq = w + 1`` (x86-TSO-ordered
    numpy stores, payload strictly before seq); the reader dispatches a
    READ-ONLY view of the slot (zero copy — the frame is consumed before
    the ack, exactly like the serve ring's slot-lifetime contract) and
    only then publishes ``ack = seq``; a slot is writable iff
    ``seq == ack``.  Wakeups reuse the serve doorbell shape: the reader
    spins a post-activity burst window, then sets its parked word and
    blocks on a unix datagram socket; the writer pokes the bell only when
    the parked word is set (the set-parked → re-check / publish → read-
    parked orderings make the missed-wake race impossible under TSO).

    TCP stays the negotiation and fallback path: frames larger than a
    slot, or arriving while the ring is full, ride the socket — the
    demux is by tag, so cross-lane ordering is free to differ.
    """

    _MAGIC = 0x52504C31  # "RPL1"
    _CTRL_WORDS = 8  # [magic, slots, slot_bytes, parked0, parked1, 0, 0, 0]
    _SLOT_HDR_WORDS = 4
    _SEQ, _ACK, _LEN = 0, 1, 2

    def __init__(self, shm, slots: int, slot_bytes: int, side: int,
                 created: bool):
        self.shm = shm
        self.name = shm.name
        self.slots = slots
        self.slot_bytes = slot_bytes
        self.side = side  # 0 = creator (offerer), 1 = attacher
        self._created = created
        self.tx_ready = False  # set once the peer confirmed the lane
        self.peer_bell: Optional[str] = None
        self._closing = False
        self._w = 0  # frames written to the tx ring
        words = np.frombuffer(shm.buf, dtype=np.uint32)
        byts = np.frombuffer(shm.buf, dtype=np.uint8)
        self._ctrl = words[: self._CTRL_WORDS]
        per_slot_words = self._SLOT_HDR_WORDS + slot_bytes // 4
        ring_words = slots * per_slot_words

        def ring(idx: int):
            base = self._CTRL_WORDS + idx * ring_words
            hdrs, pays = [], []
            for s in range(slots):
                w0 = base + s * per_slot_words
                hdrs.append(words[w0 : w0 + self._SLOT_HDR_WORDS])
                b0 = (w0 + self._SLOT_HDR_WORDS) * 4
                pays.append(byts[b0 : b0 + slot_bytes])
            return hdrs, pays

        tx, rx = (0, 1) if side == 0 else (1, 0)
        self._tx_hdrs, self._tx_pays = ring(tx)
        self._rx_hdrs, self._rx_pays = ring(rx)
        self._park_idx = 3 + side  # my reader's parked word
        self._peer_park_idx = 3 + (1 - side)
        self._bell = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self.my_bell_path = os.path.join(
            tempfile.gettempdir(),
            f"rp-rpc-{os.getpid()}-{self.name.lstrip('/')}-{side}.sock",
        )
        try:
            os.unlink(self.my_bell_path)
        except FileNotFoundError:
            pass
        self._bell.bind(self.my_bell_path)
        # park with a timeout: a lost doorbell datagram must degrade to a
        # periodic re-check, never a wedge
        self._bell.settimeout(0.1)
        self._bell_tx = socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM)
        self._bell_tx.setblocking(False)
        self._reader: Optional[threading.Thread] = None

    @classmethod
    def create(cls, slots: int = 32, slot_bytes: int = 16384) -> "_RpcShmLane":
        from multiprocessing import shared_memory

        slot_bytes = (slot_bytes + 3) & ~3  # header words need 4-alignment
        per_slot = cls._SLOT_HDR_WORDS * 4 + slot_bytes
        size = cls._CTRL_WORDS * 4 + 2 * slots * per_slot
        shm = shared_memory.SharedMemory(create=True, size=size)
        np.frombuffer(shm.buf, dtype=np.uint8)[:] = 0
        lane = cls(shm, slots, slot_bytes, side=0, created=True)
        lane._ctrl[0] = np.uint32(cls._MAGIC)
        lane._ctrl[1] = np.uint32(slots)
        lane._ctrl[2] = np.uint32(slot_bytes)
        return lane

    @classmethod
    def attach(cls, name: str, slots: int, slot_bytes: int,
               peer_bell: Optional[str] = None) -> "_RpcShmLane":
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        lane = cls(shm, slots, slot_bytes, side=1, created=False)
        if (
            int(lane._ctrl[0]) != cls._MAGIC
            or int(lane._ctrl[1]) != slots
            or int(lane._ctrl[2]) != slot_bytes
        ):
            lane.close()
            raise FabricError("rpc shm lane segment mismatch")
        lane.peer_bell = peer_bell
        return lane

    # -- writer side (single producer: callers hold the link's send lock) -----

    def try_send(self, parts: Sequence, nbytes: int) -> bool:
        """Write one frame (concatenated ``parts``, ``nbytes`` total)
        into the next tx slot; False = does not fit / ring full / lane
        closing — the caller falls back to TCP."""
        if self._closing or nbytes > self.slot_bytes:
            return False
        try:
            s = self._w % self.slots
            hdr = self._tx_hdrs[s]
            if int(hdr[self._SEQ]) != int(hdr[self._ACK]):
                return False  # reader is a full ring behind
            pay = self._tx_pays[s]
            off = 0
            for p in parts:
                m = memoryview(p)
                n = len(m)
                if n:
                    pay[off : off + n] = np.frombuffer(m, dtype=np.uint8)
                    off += n
            hdr[self._LEN] = np.uint32(nbytes)
            # payload strictly before the seq publish (the serve slot
            # contract)
            hdr[self._SEQ] = np.uint32((self._w + 1) & 0xFFFFFFFF)
            self._w += 1
            if int(self._ctrl[self._peer_park_idx]) and self.peer_bell:
                try:
                    self._bell_tx.sendto(b"\x01", self.peer_bell)
                except OSError:
                    pass  # the parked reader re-checks on its own timeout
        except (TypeError, AttributeError):
            return False  # lane torn down under us: the TCP fallback owns it
        return True

    # -- reader side ----------------------------------------------------------

    def start_reader(self, link: "RpcLink") -> None:
        self._reader = threading.Thread(
            target=self._recv_loop, args=(link,), daemon=True,
            name=f"rpc-shm-recv-{self.name}")
        self._reader.start()

    def _recv_loop(self, link: "RpcLink") -> None:
        spin_s = max(link._spin_s, 20e-6)
        r = 0
        ctrl = self._ctrl
        deadline = time.perf_counter() + spin_s
        while not self._closing:
            hdr = self._rx_hdrs[r % self.slots]
            want = np.uint32((r + 1) & 0xFFFFFFFF)
            if hdr[self._SEQ] == want and hdr[self._ACK] != want:
                ok = self._consume(link, self._rx_pays[r % self.slots],
                                   int(hdr[self._LEN]))
                # republish the slot only AFTER dispatch consumed the view
                hdr[self._ACK] = want
                r += 1
                if not ok:
                    return
                deadline = time.perf_counter() + spin_s
                continue
            if time.perf_counter() < deadline:
                time.sleep(0)  # yield the GIL inside the burst window
                continue
            ctrl[self._park_idx] = 1
            # missed-wake guard: re-check AFTER publishing parked — a
            # writer that saw parked==0 published its seq before we set
            # the word, so this re-check observes the frame
            if hdr[self._SEQ] == want and hdr[self._ACK] != want:
                ctrl[self._park_idx] = 0
                continue
            try:
                self._bell.recv(64)
            except socket.timeout:
                pass
            except OSError:
                return  # bell closed: lane teardown
            ctrl[self._park_idx] = 0
            deadline = time.perf_counter() + spin_s

    def _consume(self, link: "RpcLink", pay, ln: int) -> bool:
        if not _HDR.size <= ln <= self.slot_bytes:
            link._fail(FabricError(
                f"rpc shm frame malformed ({ln} bytes) — dropping the link"))
            return False
        tag, n_blobs, total = _HDR.unpack(pay[: _HDR.size].tobytes())
        kind = tag & _RPC_KIND_MASK
        if (
            n_blobs != 1
            or total != ln - _HDR.size
            or kind not in (TAG_RPC_REQ, TAG_RPC_RES)
        ):
            link._fail(FabricError(
                f"rpc shm frame malformed (tag {tag:#x}, {n_blobs} blobs, "
                f"{total} bytes) — dropping the link"))
            return False
        link.ep.ledger.add(
            link.ep.ledger_class, lane="shm",
            bytes_recv=ln, frames_recv=1,
        )
        # read-only zero-copy view of the slot payload, valid until the
        # ack below — same lifetime contract as the TCP arena views
        view = pay[_HDR.size : ln].view()
        view.flags.writeable = False
        try:
            link._dispatch_frame(tag, memoryview(view), "shm")
        except BaseException as e:
            if not isinstance(e, FabricError):
                e = FabricError(
                    f"rpc frame from {link.peer or 'peer'} undecodable: "
                    f"{type(e).__name__}: {e}")
            link._fail(e, e.__cause__)
            return False
        return True

    def close(self) -> None:
        self._closing = True
        for s in (self._bell, self._bell_tx):
            try:
                s.close()
            except OSError:
                pass
        try:
            os.unlink(self.my_bell_path)
        except OSError:
            pass
        if (
            self._reader is not None
            and threading.current_thread() is not self._reader
        ):
            self._reader.join(timeout=2.0)
        self._ctrl = None
        self._tx_hdrs = self._tx_pays = None
        self._rx_hdrs = self._rx_pays = None
        try:
            self.shm.close()
        except BufferError:
            import gc

            gc.collect()
            try:
                self.shm.close()
            except BufferError:
                pass  # a live dispatch view defers the unmap to exit
        if self._created:
            try:
                self.shm.unlink()
            except FileNotFoundError:
                pass


class RpcLink:
    """One RPC connection, either role (dialed or accepted).

    ``request`` registers a callback under a fresh 24-bit id and
    enqueues the frame on the sender thread; the reader thread invokes
    the callback with the response payload (a memoryview into the pooled
    arena, valid only for the duration of the call) or with the link's
    typed error.  Inbound REQUEST frames go to the endpoint's handler on
    the reader thread — the handler must fully consume (or copy) the
    payload before returning.  A socket failure is sticky: every pending
    and future callback on this link fails with the same FabricError."""

    def __init__(self, ep: "RpcEndpoint", sock: socket.socket,
                 peer: Optional[str] = None):
        self.ep = ep
        self.sock = sock
        self.peer = peer  # hostport this side dialed, None for accepted
        self.err: Optional[BaseException] = None
        self.sendq: "queue.Queue" = queue.Queue()
        self._pending: dict[int, object] = {}  # rid -> callback(payload|exc)
        self._next_id = 0
        self._lock = threading.Lock()
        self._send_lock = threading.Lock()  # serializes wire writes
        self._hdr_buf = bytearray(_HDR.size)
        self._arena = bytearray(1 << 16)
        self._spin_s = ep.spin_us / 1e6
        self._flush_s = ep.flush_us / 1e6
        self._shm: Optional[_RpcShmLane] = None
        name = peer or "accepted"
        self._sender = threading.Thread(
            target=self._send_loop, daemon=True, name=f"rpc-send-{name}")
        self._reader = threading.Thread(
            target=self._recv_loop, daemon=True, name=f"rpc-recv-{name}")
        self._sender.start()
        self._reader.start()

    # -- client role ----------------------------------------------------------

    def alloc_id(self) -> int:
        """A fresh request id (24-bit, wraps; callers embed it in the
        body BEFORE sending, so allocation is a separate step)."""
        with self._lock:
            while True:
                self._next_id = (self._next_id + 1) & _RPC_ID_MASK or 1
                if self._next_id not in self._pending:
                    return self._next_id

    def request(self, rid: int, body: bytes, on_reply,
                urgent: bool = False) -> None:
        """Send ``body`` as request ``rid``; ``on_reply(payload, lane)``
        is invoked on a reader thread with the response payload
        memoryview (and the lane that carried it), or with a
        BaseException (link failure / endpoint close).  ``urgent=True``
        bypasses any coalescing hold — the latency-critical probe
        escape hatch."""
        with self._lock:
            if self.err is not None:
                err = self.err
            else:
                self._pending[rid] = on_reply
                err = None
        if err is not None:
            on_reply(err, "tcp")
            return
        self._enqueue(TAG_RPC_REQ | (rid & _RPC_ID_MASK), body, urgent=urgent)

    def forget(self, rid: int) -> None:
        """Drop a pending request (caller-side timeout): a late response
        frame for it is discarded by the demux."""
        with self._lock:
            self._pending.pop(rid, None)

    # -- server role ----------------------------------------------------------

    def respond(self, rid: int, body: bytes) -> None:
        """Send ``body`` as the response to request ``rid`` (thread-safe
        enqueue; a dead link drops the response — the caller's retry
        policy owns that failure, exactly as a dropped TCP write would)."""
        self._enqueue(TAG_RPC_RES | (rid & _RPC_ID_MASK), body)

    # -- machinery ------------------------------------------------------------

    # inline-send cap: frames up to this ride the CALLING thread when the
    # sender is idle (one socket-buffer flush, bounded stall); bigger
    # frames always take the sender thread so a slow-reading peer can
    # only ever stall the dedicated sender, not the caller's loop
    _INLINE_SEND_MAX = 256 * 1024

    def _enqueue(self, tag: int, body: bytes, urgent: bool = False) -> None:
        nbytes = _HDR.size + len(body)
        parts = [_HDR.pack(tag, 1, len(body)), body]
        # coalescing hold (r23): with a flush window configured, small
        # frames go through the sender thread so company can share their
        # sendmsg; ``urgent`` frames (probes, explicit flush) never wait
        hold = (
            self._flush_s > 0.0
            and not urgent
            and nbytes <= _COALESCE_MAX_FRAME
        )
        # opportunistic inline send: when nothing is queued and no other
        # thread is mid-write, push the frame from THIS thread — saves a
        # cross-thread wakeup per frame, which dominates small-RPC RTT.
        # RPC frames are independent (tagged demux), so a frame slipping
        # ahead of one the sender thread just dequeued is harmless.
        if (
            not hold
            and len(body) <= self._INLINE_SEND_MAX
            and self.sendq.empty()
            and self._send_lock.acquire(blocking=False)
        ):
            try:
                if self.err is None:
                    self._write_batch([(parts, nbytes)])
                return
            except (OSError, ValueError) as e:
                self._fail(FabricPeerLost(
                    f"rpc send to {self.peer or 'peer'} failed ({e})"), e)
                return
            finally:
                self._send_lock.release()
        self.sendq.put((parts, nbytes))
        if urgent:
            # could not ride inline (sender busy / frame large): cut any
            # open coalescing window so the sender flushes immediately
            self.sendq.put(_FLUSH)

    def flush(self) -> None:
        """Explicit flush: cut any open coalescing window — queued small
        frames stop waiting for company and go to the wire now."""
        self.sendq.put(_FLUSH)

    def _write_batch(self, batch: list) -> None:
        """Write ``[(parts, nbytes), ...]`` to the wire (caller holds the
        send lock).  Each frame tries the same-host shm lane first; the
        TCP leftovers go as ONE vectored sendmsg — ``coalesced_frames``
        counts frames that shared it with at least one other."""
        led, klass = self.ep.ledger, self.ep.ledger_class
        shm = self._shm
        tcp_parts: list = []
        tcp_frames = 0
        tcp_bytes = 0
        for parts, nbytes in batch:
            # control frames (shm negotiation itself) are TCP-only —
            # the lane never carries its own handshake
            if (
                shm is not None
                and shm.tx_ready
                and parts[0][0] != (TAG_RPC_CTL >> 24)
                and shm.try_send(parts, nbytes)
            ):
                led.add(klass, lane="shm", bytes_sent=nbytes, frames_sent=1)
                continue
            tcp_parts.extend(parts)
            tcp_frames += 1
            tcp_bytes += nbytes
        if tcp_frames:
            _send_parts(self.sock, tcp_parts)
            led.add(
                klass, lane="tcp",
                bytes_sent=tcp_bytes, frames_sent=tcp_frames,
                coalesced_frames=tcp_frames if tcp_frames > 1 else 0,
            )

    def _send_loop(self) -> None:
        stop = False
        while not stop:
            job = self.sendq.get()
            if job is None:
                return
            if job is _FLUSH:
                continue
            batch = [job]
            # gather company: drain whatever is already queued, and —
            # with a flush window configured and only small frames in
            # hand — wait up to flush_us for more (bounded added latency,
            # one sendmsg instead of N)
            deadline = None
            if self._flush_s > 0.0 and job[1] <= _COALESCE_MAX_FRAME:
                deadline = time.perf_counter() + self._flush_s
            while len(batch) < _COALESCE_MAX_FRAMES:
                try:
                    nxt = self.sendq.get_nowait()
                except queue.Empty:
                    if deadline is None:
                        break
                    left = deadline - time.perf_counter()
                    if left <= 0.0:
                        break
                    try:
                        nxt = self.sendq.get(timeout=left)
                    except queue.Empty:
                        break
                if nxt is None:
                    stop = True
                    break
                if nxt is _FLUSH:
                    break
                batch.append(nxt)
                if nxt[1] > _COALESCE_MAX_FRAME:
                    deadline = None  # a big frame closes the wait window
            if self.err is not None:
                continue
            try:
                with self._send_lock:
                    self._write_batch(batch)
            except (OSError, ValueError) as e:
                self._fail(FabricPeerLost(
                    f"rpc send to {self.peer or 'peer'} failed ({e})"), e)

    def _recv_hdr(self) -> bytearray:
        """Read the 16-byte frame header, spin-then-park (r23): busy-poll
        non-blocking recv attempts for the spin window (each attempt
        releases the GIL at the syscall), then park in blocking recv —
        the serve shm ring's post-activity burst discipline applied to
        the TCP reader.  On ping-pong traffic the next frame lands
        inside the window, so steady state never pays a kernel thread
        wakeup."""
        buf = self._hdr_buf
        view = memoryview(buf)
        need = _HDR.size
        got = 0
        if self._spin_s > 0.0:
            end = time.perf_counter() + self._spin_s
            while True:
                try:
                    r = self.sock.recv_into(view, need, socket.MSG_DONTWAIT)
                except (BlockingIOError, InterruptedError):
                    if time.perf_counter() >= end:
                        break
                    continue
                if r == 0:
                    raise FabricPeerLost("fabric peer closed the connection")
                got = r
                break
        while got < need:
            r = self.sock.recv_into(view[got:], need - got)
            if r == 0:
                raise FabricPeerLost("fabric peer closed the connection")
            got += r
        return buf

    def _recv_loop(self) -> None:
        while True:
            try:
                hdr = self._recv_hdr()
                tag, n_blobs, total = _HDR.unpack(hdr)
                kind = tag & _RPC_KIND_MASK
                if (
                    n_blobs != 1
                    or total > self.ep.max_body_bytes
                    or kind not in (TAG_RPC_REQ, TAG_RPC_RES, TAG_RPC_CTL)
                ):
                    raise FabricError(
                        f"rpc frame from {self.peer or 'peer'} malformed "
                        f"(tag {tag:#x}, {n_blobs} blobs, {total} bytes) — "
                        "dropping the connection"
                    )
                if len(self._arena) < total:
                    RECV_ALLOCS.bump()
                    self._arena = bytearray(max(total, 2 * len(self._arena)))
                payload = _recv_exact(self.sock, total, self._arena)
            except BaseException as e:
                if not isinstance(e, FabricError):
                    e = FabricPeerLost(
                        f"rpc connection to {self.peer or 'peer'} lost ({e})")
                self._fail(e, e.__cause__)
                return
            self.ep.ledger.add(
                self.ep.ledger_class, lane="tcp",
                bytes_recv=_HDR.size + total, frames_recv=1,
            )
            try:
                self._dispatch_frame(tag, payload, "tcp")
            except BaseException as e:
                # an undecodable frame is a broken peer (the pre-r21
                # reader dropped the connection on garbage; same here)
                if not isinstance(e, FabricError):
                    e = FabricError(
                        f"rpc frame from {self.peer or 'peer'} undecodable: "
                        f"{type(e).__name__}: {e}")
                self._fail(e, e.__cause__)
                return

    def _dispatch_frame(self, tag: int, payload, lane: str) -> None:
        """Demux one inbound frame (either lane) on the reading thread."""
        kind = tag & _RPC_KIND_MASK
        rid = tag & _RPC_ID_MASK
        if kind == TAG_RPC_RES:
            with self._lock:
                cb = self._pending.pop(rid, None)
            if cb is not None:
                cb(payload, lane)
        elif kind == TAG_RPC_REQ:
            self.ep._handle_request(self, rid, payload)
        else:  # TAG_RPC_CTL: shm-lane negotiation (TCP only)
            self._handle_ctl(payload)

    # -- shm lane negotiation (r23) -------------------------------------------
    #
    # TCP carries the control frames: the dialer creates the segment and
    # OFFERs (name, geometry, its doorbell path); the acceptor attaches —
    # which succeeds exactly when the hosts share the segment namespace —
    # and ACKs with its own doorbell path, or NAKs (lane disabled /
    # attach failed / cross-host).  Frames ride TCP until the ack lands;
    # oversized frames and full-ring moments ride TCP forever after.

    def _offer_shm(self) -> None:
        try:
            lane = _RpcShmLane.create(
                slots=self.ep.shm_slots, slot_bytes=self.ep.shm_slot_bytes)
        except Exception:
            return  # no usable shm on this host — stay on TCP
        with self._lock:
            if self.err is not None:
                installed = False
            else:
                self._shm = lane
                installed = True
        if not installed:
            lane.close()
            return
        lane.start_reader(self)
        body = json.dumps({
            "op": "offer", "name": lane.name, "slots": lane.slots,
            "slot_bytes": lane.slot_bytes, "bell": lane.my_bell_path,
        }).encode()
        self._enqueue(TAG_RPC_CTL, body, urgent=True)

    def _handle_ctl(self, payload) -> None:
        try:
            msg = json.loads(bytes(payload))
        except ValueError as e:
            raise FabricError(
                f"rpc control frame from {self.peer or 'peer'} undecodable"
            ) from e
        op = msg.get("op")
        if op == "offer":
            if not self.ep.shm_lane or self._shm is not None:
                self._enqueue(TAG_RPC_CTL, b'{"op":"nak"}', urgent=True)
                return
            try:
                lane = _RpcShmLane.attach(
                    msg["name"], int(msg["slots"]), int(msg["slot_bytes"]),
                    peer_bell=msg.get("bell"))
            except Exception:
                self._enqueue(TAG_RPC_CTL, b'{"op":"nak"}', urgent=True)
                return
            with self._lock:
                # recheck under the link state lock: _fail may have won
                # the race and torn the link down mid-attach
                if self.err is not None or self._shm is not None:
                    installed = False
                else:
                    self._shm = lane
                    installed = True
            if not installed:
                lane.close()
                self._enqueue(TAG_RPC_CTL, b'{"op":"nak"}', urgent=True)
                return
            lane.start_reader(self)
            lane.tx_ready = True
            self._enqueue(TAG_RPC_CTL, json.dumps(
                {"op": "ack", "bell": lane.my_bell_path}).encode(),
                urgent=True)
        elif op == "ack":
            lane = self._shm
            if lane is not None:
                if msg.get("bell"):
                    lane.peer_bell = msg["bell"]
                lane.tx_ready = True
        elif op == "nak":
            with self._lock:
                # atomic swap vs. _fail: exactly one path closes the lane
                lane, self._shm = self._shm, None
            if lane is not None:
                lane.close()
        # unknown ops are ignored: forward-compatible control plane

    def _fail(self, err: BaseException, cause=None) -> None:
        if cause is not None and err.__cause__ is None:
            err.__cause__ = cause
        with self._lock:
            if self.err is None:
                self.err = err
            pending = list(self._pending.values())
            self._pending.clear()
            lane, self._shm = self._shm, None
        self.ep._unregister(self)
        # shutdown BEFORE close: a reader blocked in recv holds the
        # kernel file reference, so a bare close() would neither wake it
        # nor send FIN — the peer would never learn the link died
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if lane is not None:
            lane.close()
        # sticky-failure contract: EVERY pending waiter — loop-bridged or
        # inline/sync — observes the same typed error, exactly once (the
        # pending table pop above makes a late response frame a no-op)
        for cb in pending:
            try:
                cb(err, "tcp")
            except Exception:  # pragma: no cover - reply sinks must not throw
                pass

    def close(self, err: Optional[BaseException] = None) -> None:
        self.sendq.put(None)
        self._fail(err or FabricError("rpc link closed"))
        self._sender.join(timeout=2.0)
        if threading.current_thread() is not self._reader:
            self._reader.join(timeout=2.0)


class RpcEndpoint:
    """One node's endpoint on the RPC plane: a listener (accept thread)
    plus a dial-once outbound link registry — the connection handling,
    framing, retry surface and peer registry that ``TCPChannel`` used to
    implement on its own asyncio loop, now on the fabric core's
    persistent links.  ``handler(link, rid, payload)`` runs on reader
    threads for inbound requests; answer via ``link.respond(rid, body)``
    from any thread.

    r23 latency tiers: ``spin_us`` is the reader spin-then-park window
    (0 disables; default from ``RINGPOP_TPU_RPC_SPIN_US``); ``flush_us``
    > 0 coalesces small frames — they wait up to the window for company
    and flush as one ``sendmsg`` (``urgent`` sends and ``link.flush()``
    cut the window); ``shm_lane=True`` negotiates a same-host shm frame
    ring per dialed loopback link (``RINGPOP_TPU_RPC_SHM=1`` flips the
    default), TCP staying the negotiation and fallback path."""

    def __init__(
        self,
        handler=None,
        *,
        ledger: Optional[TransportLedger] = None,
        ledger_class: str = "rpc",
        max_body_bytes: int = MAX_RPC_BODY_BYTES,
        spin_us: Optional[float] = None,
        flush_us: float = 0.0,
        shm_lane: Optional[bool] = None,
        shm_slots: int = 32,
        shm_slot_bytes: int = 16384,
    ):
        self.handler = handler
        self.ledger = ledger if ledger is not None else TransportLedger()
        self.ledger_class = ledger_class
        self.max_body_bytes = max_body_bytes
        self.spin_us = (
            _default_spin_us() if spin_us is None else float(spin_us))
        self.flush_us = float(flush_us)
        if shm_lane is None:
            shm_lane = os.environ.get("RINGPOP_TPU_RPC_SHM", "") in (
                "1", "true", "yes")
        self.shm_lane = bool(shm_lane)
        self.shm_slots = int(shm_slots)
        self.shm_slot_bytes = int(shm_slot_bytes)
        self.hostport = ""
        self._srv: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._links: dict[str, RpcLink] = {}  # outbound, by hostport
        self._accepted: set[RpcLink] = set()
        self._lock = threading.Lock()
        self._closed = False

    # -- server side ----------------------------------------------------------

    def listen(self, host: str = "127.0.0.1", port: int = 0) -> str:
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(128)
        self._srv = srv
        addr = srv.getsockname()
        self.hostport = f"{addr[0]}:{addr[1]}"
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"rpc-accept-{self.hostport}")
        self._accept_thread.start()
        return self.hostport

    def _accept_loop(self) -> None:
        while True:
            try:
                s, _ = self._srv.accept()
            except OSError:
                return  # listener closed
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            link = RpcLink(self, s)
            with self._lock:
                closed = self._closed
                if not closed:
                    self._accepted.add(link)
            if closed:
                link.close()  # outside the lock: close unregisters
                return

    def _handle_request(self, link: RpcLink, rid: int, payload) -> None:
        if self.handler is None:
            raise FabricError("rpc request received but no handler installed")
        self.handler(link, rid, payload)

    # -- client side ----------------------------------------------------------

    def get(self, peer: str) -> Optional[RpcLink]:
        """The cached live link to ``peer``, or None (never dials)."""
        with self._lock:
            link = self._links.get(peer)
            return link if link is not None and link.err is None else None

    def connect(self, peer: str) -> RpcLink:
        """Dial-once outbound link (blocking; run off the event loop).
        A dead cached link is replaced; refusal raises FabricPeerLost."""
        with self._lock:
            if self._closed:
                raise FabricError("rpc endpoint is closed")
            link = self._links.get(peer)
            if link is not None and link.err is None:
                return link
        host, port = peer.rsplit(":", 1)
        try:
            s = socket.create_connection((host, int(port)))
        except OSError as e:
            raise FabricPeerLost(f"connect {peer}: {e}") from e
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        link = RpcLink(self, s, peer)
        with self._lock:
            cur = self._links.get(peer)
            won = cur is None or cur.err is not None
            if won:
                self._links[peer] = link
        if won:
            # same-host shm lane (r23): offer on loopback dials only —
            # attach succeeding at the acceptor IS the same-host proof,
            # but a loopback gate keeps cross-host dials from paying a
            # wasted segment + round trip
            if self.shm_lane and host in ("127.0.0.1", "::1", "localhost"):
                link._offer_shm()
            return link
        # lost a dial race; keep the established one.  close() OUTSIDE
        # the lock — it unregisters, which takes the lock again
        link.close()
        return cur

    # -- lifecycle ------------------------------------------------------------

    def _unregister(self, link: RpcLink) -> None:
        with self._lock:
            if self._links.get(link.peer) is link:
                del self._links[link.peer]
            self._accepted.discard(link)

    def wire_stats(self) -> dict:
        """This endpoint's class row of the merged ledger — the channel
        keeps its legacy ``{bytes_sent, frames_sent}`` keys from this."""
        st = self.ledger.stats()
        return st["classes"].get(
            self.ledger_class, {f: 0 for f in TransportLedger.FIELDS}
        )

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            links = list(self._links.values()) + list(self._accepted)
            self._links.clear()
            self._accepted.clear()
        if self._srv is not None:
            try:
                self._srv.close()
            except OSError:
                pass
        err = FabricPeerLost("connection closed")
        for link in links:
            link.close(err)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)


# -- the host-bridged DCN mesh: rendezvous stores, peer links, rounds ------------


class LocalKV:
    """In-process KV + barrier standing in for :class:`DistributedKV` — the
    transport is identical, so threaded single-machine tests exercise the
    real fabric code paths."""

    def __init__(self):
        self._d = {}
        self._cv = threading.Condition()
        self._barriers: dict[str, threading.Barrier] = {}
        self._block = threading.Lock()

    def key_value_set(self, key: str, value: str) -> None:
        with self._cv:
            self._d[key] = value
            self._cv.notify_all()

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        deadline = time.monotonic() + timeout_ms / 1000.0
        with self._cv:
            while key not in self._d:
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=left):
                    raise TimeoutError(f"KV key {key!r} not set within {timeout_ms} ms")
            return self._d[key]

    def barrier(self, name: str, nprocs: int, timeout_ms: int) -> None:
        with self._block:
            b = self._barriers.setdefault(name, threading.Barrier(nprocs))
        b.wait(timeout=timeout_ms / 1000.0)



class DistributedKV:
    """The job's key-value store, duck-typed to LocalKV: a client of a
    ``torch.distributed.TCPStore`` at ``address`` (``host:port``), by default
    the one the process group's rendezvous serves
    (``multihost.coordinator_address``).  Values are strings; the fabric
    only ever stores addresses and base64'd digest words here.  Keys live
    under ``ringpop-kv/`` so they never meet the process group's own.

    A barrier is a store counter: the i-th arrival at ``name`` belongs to
    generation ``i // nprocs`` and waits for that generation's release key,
    which its last arrival sets, so a name used twice never lets the
    second use through on the first one's release.  ``torch.distributed``
    is imported here, never at module import."""

    _PREFIX = "ringpop-kv/"

    def __init__(self, address: Optional[str] = None):
        import torch.distributed as dist

        from ringpop_tpu_torch.parallel import multihost

        address = address or multihost.coordinator_address()
        if not address:
            raise RuntimeError(
                "torch.distributed is not initialized — call "
                "parallel.multihost.init_distributed() first"
            )
        host, port = address.rsplit(":", 1)
        self._s = dist.TCPStore(host, int(port), is_master=False, timeout=timedelta(minutes=10))

    def _wait(self, key: str, timeout_ms: int) -> None:
        try:
            self._s.wait([key], timedelta(milliseconds=timeout_ms))
        except RuntimeError as e:  # torch.distributed.DistStoreError
            raise TimeoutError(f"KV key {key!r} not set within {timeout_ms} ms") from e

    def key_value_set(self, key: str, value: str) -> None:
        self._s.set(self._PREFIX + key, value)

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        self._wait(self._PREFIX + key, timeout_ms)
        return self._s.get(self._PREFIX + key).decode()

    def barrier(self, name: str, nprocs: int, timeout_ms: int) -> None:
        key = f"{self._PREFIX}barrier/{name}"
        arrival = self._s.add(f"{key}/count", 1) - 1
        release = f"{key}/release/{arrival // nprocs}"
        if arrival % nprocs == nprocs - 1:
            self._s.set(release, "1")
        self._wait(release, timeout_ms)


class _Future:
    """One pending send or receive: an event plus a value-or-error slot.
    ``value`` for a send is the monotonic completion timestamp (the
    drain-timing hook); for a receive, the decoded array list."""

    __slots__ = ("ev", "value", "err")

    def __init__(self):
        self.ev = threading.Event()
        self.value = None
        self.err: Optional[BaseException] = None

    def fulfill(self, value) -> None:
        self.value = value
        self.ev.set()

    def fail(self, err: BaseException) -> None:
        self.err = err
        self.ev.set()


class _RecvJob(NamedTuple):
    tag: int
    stream: Optional[str]
    fut: _Future




class _PeerLink:
    """One peer's persistent send/receive machinery: a sender thread
    draining a FIFO of pre-packed wire messages and a receiver thread
    draining a FIFO of tagged expectations.  Errors are STICKY — after a
    socket failure every queued and future job on that side of the link
    fails with the same typed error (the socket state is undefined after
    a partial frame, so there is nothing to resume)."""

    def __init__(self, fabric: "Fabric", peer: int, sock: socket.socket):
        self.fabric = fabric
        self.peer = peer
        self.sock = sock
        self.sendq: "queue.Queue" = queue.Queue()
        self.recvq: "queue.Queue" = queue.Queue()
        self.send_err: Optional[BaseException] = None
        self.recv_err: Optional[BaseException] = None
        # pooled receive buffers (r21): one header buf + one growable
        # payload arena per link, reused across every frame this
        # receiver thread reads — frames no longer cost an allocation
        self._hdr_buf = bytearray(_HDR.size)
        self._arena = bytearray(1 << 16)
        self._sender = threading.Thread(
            target=self._send_loop, daemon=True,
            name=f"fabric-r{fabric.rank}-send-p{peer}",
        )
        self._receiver = threading.Thread(
            target=self._recv_loop, daemon=True,
            name=f"fabric-r{fabric.rank}-recv-p{peer}",
        )
        self._sender.start()
        self._receiver.start()

    def _drain_failed(self, q, err: BaseException) -> None:
        """Fail every still-queued job on ``q`` — a loop exiting early
        (fabric closed) must not leave later futures unfulfilled, or
        their waiters would block into a misleading timeout."""
        while True:
            try:
                job = q.get_nowait()
            except queue.Empty:
                return
            if job is None:
                continue
            # send jobs are (fut, msg, tag) tuples; recv jobs are
            # _RecvJob NamedTuples — which are ALSO tuples, so match the
            # typed one first
            fut = job.fut if isinstance(job, _RecvJob) else job[0]
            fut.fail(err)

    def _arena_for(self, n: int) -> bytearray:
        """The payload arena, grown geometrically when a frame exceeds
        it (growth counts as ONE allocation on ``RECV_ALLOCS``; steady-
        state frames then reuse it for free)."""
        if len(self._arena) < n:
            RECV_ALLOCS.bump()
            self._arena = bytearray(max(n, 2 * len(self._arena)))
        return self._arena

    def _send_loop(self) -> None:
        while True:
            job = self.sendq.get()
            if job is None:
                return
            fut, msg, tag = job
            if self.send_err is not None:
                fut.fail(self.send_err)
                continue
            try:
                _send_parts(self.sock, msg)
                fut.fulfill(time.monotonic())
            except socket.timeout as e:
                self.send_err = FabricTimeout(
                    f"rank {self.fabric.rank}: send to peer {self.peer} "
                    f"(tag {tag}) could not drain within "
                    f"{self.fabric.timeout_ms} ms — peer wedged or partitioned"
                )
                self.send_err.__cause__ = e
                if self.fabric.notify_failures:
                    _notify_failure(self.send_err)
                fut.fail(self.send_err)
            except OSError as e:
                if self.fabric._closed:
                    err = FabricError(
                        f"rank {self.fabric.rank}: fabric closed with a send "
                        f"to peer {self.peer} still queued")
                    fut.fail(err)
                    self._drain_failed(self.sendq, err)
                    return
                self.send_err = FabricPeerLost(
                    f"rank {self.fabric.rank}: send to peer {self.peer} "
                    f"(tag {tag}) failed ({e}) — peer process died mid-exchange"
                )
                self.send_err.__cause__ = e
                if self.fabric.notify_failures:
                    _notify_failure(self.send_err)
                fut.fail(self.send_err)

    def _recv_loop(self) -> None:
        while True:
            job = self.recvq.get()
            if job is None:
                return
            if self.recv_err is not None:
                job.fut.fail(self.recv_err)
                continue
            try:
                job.fut.fulfill(
                    self.fabric._recv(self.peer, job.tag, job.stream, link=self)
                )
            except FabricError as e:
                if self.fabric._closed:
                    err = FabricError(
                        f"rank {self.fabric.rank}: fabric closed with a "
                        f"receive from peer {self.peer} still pending")
                    job.fut.fail(err)
                    self._drain_failed(self.recvq, err)
                    return
                self.recv_err = e
                if self.fabric.notify_failures:
                    _notify_failure(e)
                job.fut.fail(e)
            except BaseException as e:  # decode bugs must not hang waiters
                self.recv_err = FabricError(
                    f"rank {self.fabric.rank}: receive from peer {self.peer} "
                    f"(tag {job.tag}) failed: {type(e).__name__}: {e}"
                )
                self.recv_err.__cause__ = e
                job.fut.fail(self.recv_err)

    def shutdown(self) -> None:
        # let queued sends drain briefly BEFORE the socket closes (an
        # overlapped final round may still be in the queue); a peer-dead
        # stall is bounded by the join timeout, then the close forces the
        # sender out
        self.sendq.put(None)
        self._sender.join(timeout=2.0)
        self.recvq.put(None)
        try:
            self.sock.close()
        except OSError:
            pass
        self._sender.join(timeout=2.0)
        self._receiver.join(timeout=2.0)


class ExchangeHandle:
    """The completion handle of one asynchronous fabric round.

    ``wait()`` (the default, ``join_sends=True``) reproduces the
    blocking ``exchange`` contract exactly: receives joined in order,
    sends joined, every error of the round aggregated into one raise.
    ``wait(join_sends=False)`` joins ONLY the receives — the engine's
    cross-tick overlap mode: the send drain continues on the persistent
    sender threads, ordered FIFO behind nothing (a later round's payload
    cannot overtake it), and a drain failure is sticky on the link so it
    surfaces at the next enqueue or wait touching that peer.
    """

    def __init__(self, fabric: "Fabric", tag: int, recv_futs, send_futs):
        self.fabric = fabric
        self.tag = tag
        self._recv_futs = recv_futs  # [(peer, _Future)] in recv_from order
        self._send_futs = send_futs  # [(peer, _Future)] in enqueue order
        self.issued_s = time.monotonic()
        self.waited_s = 0.0  # total wall spent blocked in wait() calls

    def _budget_s(self) -> float:
        # the socket-level timeout fires first with its richer message;
        # the margin only catches a wedged demux thread
        return self.fabric.timeout_ms / 1000.0 + 5.0

    def wait(self, join_sends: bool = True) -> dict[int, list[np.ndarray]]:
        t0 = time.monotonic()
        deadline = t0 + self._budget_s()
        errs: list[BaseException] = []
        out: dict[int, list[np.ndarray]] = {}
        try:
            for peer, fut in self._recv_futs:
                if not fut.ev.wait(timeout=max(0.0, deadline - time.monotonic())):
                    errs.append(FabricTimeout(
                        f"rank {self.fabric.rank}: completion for tag "
                        f"{self.tag} from peer {peer} not fulfilled within "
                        f"{self.fabric.timeout_ms} ms"))
                    continue
                if fut.err is not None:
                    errs.append(fut.err)
                else:
                    out[peer] = fut.value
            for peer, fut in self._send_futs:
                if not join_sends:
                    # non-blocking: surface only already-failed sends
                    if fut.ev.is_set() and fut.err is not None:
                        errs.append(fut.err)
                    continue
                if not fut.ev.wait(timeout=max(0.0, deadline - time.monotonic())):
                    errs.append(FabricTimeout(
                        f"rank {self.fabric.rank}: send to peer {peer} for "
                        f"tag {self.tag} still undrained within "
                        f"{self.fabric.timeout_ms} ms"))
                elif fut.err is not None:
                    errs.append(fut.err)
        finally:
            self.waited_s += time.monotonic() - t0
        if errs:
            _aggregate_raise(errs, notify=self.fabric.notify_failures)
        return out

    def poll(self) -> Optional[dict[int, Union[list, BaseException]]]:
        """Non-blocking completion probe of the RECEIVE side: ``None``
        while any expectation is still outstanding, else a map ``peer ->
        decoded arrays`` (or the typed error that leg failed with —
        returned, not raised, so a poller can keep serving the live
        peers).  Sends are untouched — accounting, sticky errors and the
        overlap contract behave exactly as if this was never called.
        The obs plane's rank-0 collector harvests rounds through this."""
        out: dict[int, Union[list, BaseException]] = {}
        for peer, fut in self._recv_futs:
            if not fut.ev.is_set():
                return None
            out[peer] = fut.err if fut.err is not None else fut.value
        return out

    def sends_done_s(self) -> Optional[float]:
        """Monotonic timestamp when the LAST send of this round hit the
        socket — ``None`` while any is still draining (or failed).  The
        engine's ``overlap_hidden_ms`` gauge reads this after the fact."""
        done = self.issued_s
        for _, fut in self._send_futs:
            if not fut.ev.is_set() or fut.err is not None:
                return None
            done = max(done, fut.value)
        return done



class Fabric:
    """One rank's endpoint of the host-bridged DCN mesh.

    ``kv`` is a LocalKV (threaded tests) or DistributedKV (real OS
    processes).  ``namespace`` isolates concurrent fabrics in one KV store
    (tests, or a snapshot fabric next to a run fabric).
    """

    def __init__(
        self,
        rank: int,
        nprocs: int,
        kv,
        namespace: str = "fabric",
        host: str = "127.0.0.1",
        timeout_ms: int = 120_000,
        codec: bool = True,
        notify_failures: bool = True,
        ledger: Optional[TransportLedger] = None,
        ledger_class: str = "exchange",
        rejoin: bool = False,
    ):
        if not 0 <= rank < nprocs:
            raise ValueError(f"rank {rank} outside [0, {nprocs})")
        self.rank, self.nprocs = rank, nprocs
        self.kv, self.ns = kv, namespace
        self.timeout_ms = timeout_ms
        self.codec = codec
        # the merged transport ledger (r21): every legacy counter below
        # is mirrored into it under ledger_class, so per-class ledger
        # sums equal this fabric's own wire_stats by construction —
        # pass a shared ledger to account several transports together
        # (the obs fabric registers as class "obs", the channel's RPC
        # plane as "rpc", the shm ring as "shm")
        self.ledger = ledger if ledger is not None else TransportLedger()
        self.ledger_class = ledger_class
        # notify_failures=False opts this fabric OUT of the global
        # failure hooks (obs/flight): the obs plane's own side-channel
        # fabric tolerates rank skew as routine — its timeouts must not
        # burn the flight recorder's once-per-process dump that exists
        # for ENGINE fabric failures
        self.notify_failures = notify_failures
        self.bytes_sent = 0  # actual wire bytes
        self.bytes_recv = 0
        self.raw_bytes_sent = 0  # what the same messages cost codec-off
        self.raw_bytes_recv = 0
        self.codec_counts: dict[int, int] = {}  # sent arrays per codec byte
        # XOR-delta stream state: (peer, stream, array-idx) -> payload
        # bytes recorded under codec_epoch; reset_codec_state() clears both
        # sides' dicts and bumps the epoch word (collective by convention:
        # every rank resets at the same protocol point — snapshot restore)
        self.codec_epoch = 0
        self._tx_prev: dict[tuple, bytes] = {}
        self._rx_prev: dict[tuple, bytes] = {}
        self._peers: dict[int, socket.socket] = {}
        self._links: dict[int, _PeerLink] = {}
        self._closed = False
        self._lock = threading.Lock()
        # rejoin support: a RESTARTED rank cannot redo the normal
        # bring-up (its peers' accept listeners closed after the mesh
        # came up) — rejoin=True instead advertises a fresh listener in
        # the KV and waits for a surviving rank's reconnect_peer() to
        # dial it.  The dial hello carries a 4-byte token the dialer
        # chooses (the obs plane passes its sync seq so the restarted
        # rank adopts the live tag sequence); it lands in rejoin_token.
        self.rejoin_token = 0
        self._rejoin_seen: dict[int, str] = {}
        if nprocs > 1:
            if rejoin:
                self._rejoin_listen(host)
            else:
                self._connect(host)
                for peer, s in self._peers.items():
                    self._links[peer] = _PeerLink(self, peer, s)

    # -- bring-up -------------------------------------------------------------

    def _connect(self, host: str) -> None:
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, 0))
        srv.listen(self.nprocs)
        # the timeout contract covers BOTH sides of every link: a rank
        # that dies before dialing must fail its peers' accept() at
        # timeout_ms, not hang them forever; accepted and dialed sockets
        # alike carry the timeout so a stalled (not closed) peer surfaces
        # as socket.timeout instead of a wedged _recv_exact
        srv.settimeout(self.timeout_ms / 1000.0)
        port = srv.getsockname()[1]
        self.kv.key_value_set(f"{self.ns}/addr/{self.rank}", f"{host}:{port}")
        # deterministic dial direction: every rank dials its LOWER peers;
        # the accept side learns the dialer's rank from a 4-byte hello
        for peer in range(self.rank):
            addr = self.kv.blocking_key_value_get(f"{self.ns}/addr/{peer}", self.timeout_ms)
            h, p = addr.rsplit(":", 1)
            deadline = time.monotonic() + self.timeout_ms / 1000.0
            while True:
                try:
                    s = socket.create_connection((h, int(p)), timeout=self.timeout_ms / 1000.0)
                    break
                except ConnectionRefusedError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.02)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(self.timeout_ms / 1000.0)
            _send_exact(s, struct.pack(">I", self.rank))
            self._peers[peer] = s
        for _ in range(self.rank + 1, self.nprocs):
            s, _ = srv.accept()
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(self.timeout_ms / 1000.0)
            (peer,) = struct.unpack(">I", _recv_exact(s, 4))
            self._peers[peer] = s
        srv.close()

    def _rejoin_listen(self, host: str) -> None:
        """Restarted-rank bring-up: advertise a one-shot listener under
        ``{ns}/rejoin/{rank}`` (stamped with ``time_ns`` so a surviving
        rank distinguishes this incarnation's advert from a stale one)
        and accept exactly one :meth:`reconnect_peer` dial in the
        background — the fabric is usable immediately, link-less, and
        ``has_link`` turns true once the dial lands."""
        srv = socket.socket()
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, 0))
        srv.listen(self.nprocs)
        srv.settimeout(self.timeout_ms / 1000.0)
        port = srv.getsockname()[1]
        self.kv.key_value_set(
            f"{self.ns}/rejoin/{self.rank}", f"{time.time_ns()}:{host}:{port}"
        )

        def accept_one() -> None:
            try:
                s, _ = srv.accept()
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                s.settimeout(self.timeout_ms / 1000.0)
                peer, token = struct.unpack(">II", _recv_exact(s, 8))
                with self._lock:
                    if self._closed:
                        s.close()
                        return
                    self.rejoin_token = token
                    self._peers[peer] = s
                    self._links[peer] = _PeerLink(self, peer, s)
            except (OSError, struct.error, FabricError):
                pass
            finally:
                srv.close()

        threading.Thread(
            target=accept_one, daemon=True,
            name=f"fabric-rejoin-{self.ns}-{self.rank}",
        ).start()

    def has_link(self, peer: int) -> bool:
        """Whether a live(-looking) link to ``peer`` exists — rejoining
        ranks poll this to learn when their advert has been dialed."""
        with self._lock:
            return peer in self._links

    def reconnect_peer(self, peer: int, token: int = 0) -> bool:
        """Dial a restarted ``peer``'s rejoin advert and swap in a fresh
        link (the old link, if any, is shut down).  Returns False — and
        never raises — when no NEW advert exists (no advert published,
        or the same incarnation was already dialed) or the dial fails;
        True once the new link is installed.  ``token`` rides the hello
        into the peer's ``rejoin_token``."""
        try:
            advert = self.kv.blocking_key_value_get(f"{self.ns}/rejoin/{peer}", 1)
        except Exception:
            return False
        if advert == self._rejoin_seen.get(peer):
            return False
        try:
            _stamp, rest = advert.split(":", 1)
            h, p = rest.rsplit(":", 1)
            s = socket.create_connection(
                (h, int(p)), timeout=self.timeout_ms / 1000.0
            )
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.settimeout(self.timeout_ms / 1000.0)
            _send_exact(s, struct.pack(">II", self.rank, token & 0xFFFFFFFF))
        except (OSError, ValueError):
            return False
        with self._lock:
            old_link = self._links.pop(peer, None)
            old_sock = self._peers.pop(peer, None)
        if old_link is not None:
            old_link.shutdown()
        if old_sock is not None:
            try:
                old_sock.close()
            except OSError:
                pass
        with self._lock:
            if self._closed:
                s.close()
                return False
            self._peers[peer] = s
            self._links[peer] = _PeerLink(self, peer, s)
        self._rejoin_seen[peer] = advert
        return True

    def close(self) -> None:
        self._closed = True
        for link in self._links.values():
            link.shutdown()
        self._links.clear()
        for s in self._peers.values():
            try:
                s.close()
            except OSError:
                pass
        self._peers.clear()

    def __enter__(self) -> "Fabric":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- framed numpy messages ------------------------------------------------

    def reset_codec_state(self) -> None:
        """Drop every XOR-delta stream and bump the epoch word.  Call at
        any protocol point where the payload history breaks — snapshot
        restore, engine re-init — on EVERY rank (the epoch word in each
        XOR frame turns a missed reset into a loud ``FabricError`` instead
        of silently decoded garbage)."""
        with self._lock:
            self.codec_epoch += 1
            self._tx_prev.clear()
            self._rx_prev.clear()

    def wire_stats(self) -> dict:
        """Counter snapshot for journals/bench records (wire vs raw bytes
        + per-codec sent-array counts, names not bytes)."""
        with self._lock:
            return {
                "bytes_sent": self.bytes_sent,
                "bytes_recv": self.bytes_recv,
                "raw_bytes_sent": self.raw_bytes_sent,
                "raw_bytes_recv": self.raw_bytes_recv,
                "codec_counts": {
                    CODEC_NAMES.get(c, str(c)): n
                    for c, n in sorted(self.codec_counts.items())
                },
            }

    def _encode_item(
        self, item: Union[np.ndarray, Encoded], peer: int, stream, idx: int
    ) -> Encoded:
        if isinstance(item, Encoded):
            if stream is not None:
                # the sender has no raw bytes to record as XOR history,
                # but the receiver records its decode — the two prevs
                # would diverge under MATCHING epochs, defeating the
                # epoch word's whole purpose.  Refuse rather than
                # corrupt (today's pre-encoded path, the exchange legs,
                # is stream-less by design: window shapes move with s).
                raise ValueError(
                    "pre-encoded (Encoded) items cannot ride a streamed "
                    "round: the XOR-delta payload history would diverge "
                    "between sender and receiver — send the ndarray, or "
                    "drop the stream"
                )
            return item  # pre-encoded (device-sourced ROWS) — pass through
        a = np.ascontiguousarray(item)
        if not self.codec:
            return Encoded(CODEC_RAW, a.dtype, a.shape, a.tobytes(), a.nbytes)
        prev = self._tx_prev.get((peer, stream, idx)) if stream is not None else None
        enc = encode_array(a, prev=prev, epoch=self.codec_epoch)
        if stream is not None:
            self._tx_prev[(peer, stream, idx)] = a.tobytes()
        return enc

    def _pack(
        self, tag: int, arrays, peer: int, stream=None
    ) -> tuple[list, int, int]:
        """-> (iovec parts, wire size, raw-equivalent size).  The parts
        list goes to the sender thread's vectored ``sendmsg`` as-is —
        payload buffers are never ``+``-concatenated into a wire-sized
        copy (the r21 zero-copy send path); only the small per-array
        metadata strips are joined."""
        parts: list = [None]  # the _HDR slot, filled once total is known
        total = 0
        raw_total = _HDR.size
        counts: dict[int, int] = {}
        for idx, item in enumerate(arrays):
            enc = self._encode_item(item, peer, stream, idx)
            dt = enc.dtype.str.encode()
            shape = np.asarray(enc.shape, ">u8").tobytes()
            meta = _AHDR.pack(enc.codec, len(dt), len(enc.shape), len(enc.payload))
            parts.append(meta + dt + shape)
            parts.append(enc.payload)
            total += len(parts[-2]) + len(parts[-1])
            raw_total += len(meta) + len(dt) + len(shape) + enc.raw_nbytes
            counts[enc.codec] = counts.get(enc.codec, 0) + 1
        parts[0] = _HDR.pack(tag, len(arrays), total)
        with self._lock:
            for c, k in counts.items():
                self.codec_counts[c] = self.codec_counts.get(c, 0) + k
        return parts, _HDR.size + total, raw_total

    def _recv(self, peer: int, tag: int, stream=None, link=None) -> list[np.ndarray]:
        sock = self._peers[peer]
        try:
            hdr = _recv_exact(
                sock, _HDR.size, link._hdr_buf if link is not None else None
            )
            got_tag, n_arrays, total = _HDR.unpack(hdr)
            if got_tag != tag:
                raise FabricDesync(
                    f"fabric desync: rank {self.rank} expected tag {tag} from peer "
                    f"{peer}, got {got_tag} — a leg was skipped or reordered"
                )
            # the payload lands in the link's pooled arena; every decode
            # below materializes fresh arrays before the next frame
            # reuses it (decode_array copies exactly where the caller
            # outlives the arena)
            payload = _recv_exact(
                sock, total, link._arena_for(total) if link is not None else None
            )
        except socket.timeout as e:
            raise FabricTimeout(
                f"rank {self.rank}: peer {peer} sent nothing for tag {tag} "
                f"within {self.timeout_ms} ms — peer dead-but-connected, "
                "wedged, or partitioned (NOT a tag desync: nothing arrived "
                "at all)"
            ) from e
        except FabricPeerLost as e:
            raise FabricPeerLost(
                f"rank {self.rank}: peer {peer} closed its socket while this "
                f"rank awaited tag {tag} — peer process died mid-exchange"
            ) from e
        except OSError as e:
            # RST instead of FIN: the peer died with OUR data still in
            # flight to it — same diagnosis as a clean close
            raise FabricPeerLost(
                f"rank {self.rank}: connection to peer {peer} reset while "
                f"this rank awaited tag {tag} ({e}) — peer process died "
                "mid-exchange"
            ) from e
        out, off = [], 0
        raw_total = _HDR.size
        for idx in range(n_arrays):
            codec, dtl, ndim, nbytes = _AHDR.unpack_from(payload, off)
            off += _AHDR.size
            dt = bytes(payload[off : off + dtl]).decode()
            off += dtl
            shape = tuple(np.frombuffer(payload, ">u8", count=ndim, offset=off).astype(int))
            off += 8 * ndim
            prev = self._rx_prev.get((peer, stream, idx)) if stream is not None else None
            a = decode_array(
                codec, np.dtype(dt), shape, payload[off : off + nbytes],
                prev=prev, epoch=self.codec_epoch,
            )
            if stream is not None:
                self._rx_prev[(peer, stream, idx)] = a.tobytes()
            out.append(a)
            raw_total += _AHDR.size + dtl + 8 * ndim + a.nbytes
            off += nbytes
        with self._lock:
            self.bytes_recv += len(hdr) + total
            self.raw_bytes_recv += raw_total
        self.ledger.add(
            self.ledger_class,
            bytes_recv=len(hdr) + total, raw_bytes_recv=raw_total,
            frames_recv=1,
        )
        return out

    # -- rounds ---------------------------------------------------------------

    def exchange_async(
        self,
        tag: int,
        sends: dict[int, Sequence[Union[np.ndarray, Encoded]]],
        recv_from: Sequence[int],
        stream: Optional[str] = None,
    ) -> ExchangeHandle:
        """Enqueue one deterministic communication round and return its
        completion handle: each payload in ``sends`` is packed HERE (so
        byte accounting and the XOR-delta payload history advance in
        program order — the double-buffering invariant the overlapped
        engine leans on) and drained by the peer's persistent sender
        thread; each peer in ``recv_from`` gets one tagged expectation
        queued on its receiver thread.  Both sides must derive the same
        schedule — a mismatch surfaces as a tag desync or timeout, never
        silent misdata.  ``stream`` (a tick-stable name) opts the round's
        arrays into the XOR-delta codec: the previous payload per (peer,
        stream, index) is retained on both sides, so only use it for
        rounds whose shapes recur (the reduce words — retaining a full
        window would double memory for no ratio)."""
        if self._closed:
            raise FabricError(f"rank {self.rank}: fabric is closed")
        if stream is not None:
            # validate BEFORE any socket work so the contract violation
            # raises synchronously on every rank instead of leaving the
            # peers blocked into a timeout (_encode_item's check would
            # only fire inside a sender thread)
            for arrays in sends.values():
                for it in arrays:
                    if isinstance(it, Encoded):
                        raise ValueError(
                            "pre-encoded (Encoded) items cannot ride a "
                            "streamed round: the XOR-delta payload history "
                            "would diverge between sender and receiver — "
                            "send the ndarray, or drop the stream"
                        )
        # a sticky drain failure from an earlier UNJOINED round (the
        # overlap mode) surfaces at the next enqueue, not never
        sticky = [
            link.send_err
            for link in self._links.values()
            if link.send_err is not None
        ]
        if sticky:
            _aggregate_raise(sticky, notify=self.notify_failures)
        send_futs: list[tuple[int, _Future]] = []
        # packing runs HERE, serially, and that is a deliberate trade:
        # program-order packing is what keeps the XOR history and the
        # byte counters deterministic (readable mid-drain by journals),
        # and the fan-out is small by construction — a cyclic window leg
        # sends to <= 2 peers (a block window spans at most two owner
        # blocks, any P), a swing round to exactly 1; only the tiny
        # reduce words ever fan to P-1
        for peer, arrays in sends.items():
            parts, wire, raw = self._pack(tag, arrays, peer, stream)
            with self._lock:
                self.bytes_sent += wire
                self.raw_bytes_sent += raw
            self.ledger.add(
                self.ledger_class,
                bytes_sent=wire, raw_bytes_sent=raw, frames_sent=1,
            )
            fut = _Future()
            self._links[peer].sendq.put((fut, parts, tag))
            send_futs.append((peer, fut))
        recv_futs: list[tuple[int, _Future]] = []
        for peer in recv_from:
            fut = _Future()
            self._links[peer].recvq.put(_RecvJob(tag, stream, fut))
            recv_futs.append((peer, fut))
        return ExchangeHandle(self, tag, recv_futs, send_futs)

    def exchange(
        self,
        tag: int,
        sends: dict[int, Sequence[Union[np.ndarray, Encoded]]],
        recv_from: Sequence[int],
        stream: Optional[str] = None,
    ) -> dict[int, list[np.ndarray]]:
        """The synchronous round: ``exchange_async(...).wait()`` —
        receives joined in ``recv_from`` order, sends joined, every
        failure of the round aggregated into one raise (see
        ``_aggregate_raise``)."""
        return self.exchange_async(tag, sends, recv_from, stream=stream).wait()

    def allgather(
        self,
        tag: int,
        arr: np.ndarray,
        stream: Optional[str] = None,
        schedule: str = "cyclic",
        join_sends: bool = True,
        on_round=None,
    ) -> list[np.ndarray]:
        """Every rank's ``arr``, ordered by rank (self included).  Tiny
        payloads only (reduce words, digest partials).

        ``schedule="cyclic"`` is one full-mesh round (P-1 sends, P-1
        receives).  ``schedule="swing"`` is recursive doubling: log2(P)
        rounds against ONE partner at distance 2^j each, the accumulated
        half forwarded whole — the gather analog of the Swing exchange
        (requires a power-of-two P; the returned per-rank arrays are
        byte-identical either way, so any bitwise combine over them is
        schedule-invariant).  Round j's wire tag is ``tag + j`` — callers
        keep the low nibble of their leg tags clear for it.
        ``join_sends=False`` lets the final round's drain overlap the
        caller's next compute (the engine's overlap mode); ``on_round``
        (called with each round's ExchangeHandle right after its wait)
        hands those still-draining handles to the caller — the engine's
        overlap-hidden gauge folds the reduce drain through it."""
        if self.nprocs == 1:
            return [np.asarray(arr)]
        if schedule == "swing":
            if self.nprocs & (self.nprocs - 1):
                raise ValueError(
                    f"swing allgather requires a power-of-two process "
                    f"count, got {self.nprocs}"
                )
            have = {self.rank: np.asarray(arr)}
            for j in range(self.nprocs.bit_length() - 1):
                q = self.rank ^ (1 << j)
                order = sorted(have)
                h = self.exchange_async(
                    (tag + j) & 0xFFFFFFFF,
                    {q: [have[r] for r in order]},
                    [q],
                    stream=None if stream is None else f"{stream}/sw{j}",
                )
                got = h.wait(join_sends=join_sends)
                if on_round is not None:
                    on_round(h)
                for r, a in zip(sorted(r ^ (1 << j) for r in order), got[q]):
                    have[r] = a
            return [have[r] for r in range(self.nprocs)]
        if schedule != "cyclic":
            raise ValueError(f"unknown allgather schedule {schedule!r}")
        peers = [p for p in range(self.nprocs) if p != self.rank]
        h = self.exchange_async(
            tag, {p: [np.asarray(arr)] for p in peers}, peers, stream=stream
        )
        got = h.wait(join_sends=join_sends)
        if on_round is not None:
            on_round(h)
        return [
            np.asarray(arr) if r == self.rank else got[r][0]
            for r in range(self.nprocs)
        ]

    def barrier(self, name: str) -> None:
        if self.nprocs > 1:
            self.kv.barrier(f"{self.ns}/{name}", self.nprocs, self.timeout_ms)

    # -- tiny named value broadcast (rank 0 -> all), via the KV store --------

    def publish(self, name: str, arr: np.ndarray) -> None:
        a = np.ascontiguousarray(arr)
        shape = ",".join(map(str, a.shape))
        body = base64.b64encode(a.tobytes()).decode()
        self.kv.key_value_set(f"{self.ns}/pub/{name}", f"{a.dtype.str}|{shape}|{body}")

    def lookup(self, name: str) -> np.ndarray:
        raw = self.kv.blocking_key_value_get(f"{self.ns}/pub/{name}", self.timeout_ms)
        descr, shape_s, body = raw.split("|", 2)
        shape = tuple(int(x) for x in shape_s.split(",") if x)
        return np.frombuffer(base64.b64decode(body), np.dtype(descr)).reshape(shape).copy()


# -- the RPC plane (r21): request/response tag family on the fabric core -----
#
# The channel's TCP transport (net/channel.py) used to own its OWN asyncio

# -- cyclic-window arithmetic (shared by both endpoints of every leg) ---------


def window_pieces(start: int, length: int, n: int) -> list[tuple[int, int]]:
    """The cyclic row window ``[start, start+length) mod n`` as ordered
    contiguous global pieces (at most two).  ``start`` is taken mod ``n``
    (negative and >= n shifts are legal); a zero-length window is the
    empty list; ``length`` beyond ``n`` is a contract violation (the
    window would cover rows twice)."""
    if not 0 <= length <= n:
        raise ValueError(f"window length {length} outside [0, n={n}]")
    if length == 0:
        return []
    start %= n
    if start + length <= n:
        return [(start, length)]
    return [(start, n - start), (0, start + length - n)]


def intersect(a_lo: int, a_len: int, b_lo: int, b_len: int) -> Optional[tuple[int, int]]:
    lo = max(a_lo, b_lo)
    hi = min(a_lo + a_len, b_lo + b_len)
    return (lo, hi - lo) if hi > lo else None


def plan_window(
    want_start: int, block: int, n: int, nprocs: int
) -> list[tuple[int, int, int, int]]:
    """Assembly plan for the cyclic window ``[want_start, want_start+block)``
    over equal process blocks: ordered ``(owner_rank, global_lo, length,
    window_offset)`` entries, window offsets ascending.  Derived
    identically on every rank — the sender runs it for the RECEIVER's
    window to learn what to send.  ``n`` must divide evenly over
    ``nprocs``: silently planning over truncated ``n // nprocs`` blocks
    would assign the ring's tail rows to no owner (the same divisibility
    ``partition.process_block`` imposes, surfaced HERE because this
    function is also reachable from schedule tooling that never builds a
    partition)."""
    if nprocs < 1:
        raise ValueError(f"nprocs must be >= 1, got {nprocs}")
    if n % nprocs:
        raise ValueError(
            f"n={n} does not divide over {nprocs} processes — equal-block "
            "window plans would drop the tail rows (pad n or change the "
            "process count)"
        )
    b = n // nprocs
    out = []
    off = 0
    for glo, glen in window_pieces(want_start, block, n):
        # owners overlapping [glo, glo+glen)
        first, last = glo // b, (glo + glen - 1) // b
        for r in range(first, last + 1):
            piece = intersect(glo, glen, r * b, b)
            assert piece is not None
            out.append((r, piece[0], piece[1], off + piece[0] - glo))
        off += glen
    return out


@functools.lru_cache(maxsize=8192)
def plan_window_swing(
    rel_start: int, n: int, nprocs: int
) -> tuple[dict[int, tuple], ...]:
    """Distance-halving relay schedule for the per-rank block windows
    ``[rank*b + rel_start, ...+b) mod n`` (Swing-style, PAPERS arxiv
    2401.09356, realized as hypercube dimension-fixing on the full-mesh
    fabric): ``log2(P)`` rounds, each rank talking to exactly ONE partner
    at distance ``2^j``, relay ranks forwarding coalesced pieces — vs the
    cyclic :func:`plan_window` execution's direct sends to partners at
    arbitrary ring distance.  On a physical ring/torus DCN that bounds
    the worst-case leg count at O(log P) power-of-two hops instead of the
    O(P)-step walk a distant window piece implies; on this TCP mesh the
    hop count is priced honestly as relay bytes (the wire accounting
    counts every forwarded copy).

    Returns one manifest per round: ``rounds[j]`` maps ``holder_rank`` to
    its ordered entries ``(dest, owner, global_lo, length, window_off)``;
    every listed entry moves ``holder -> holder ^ (1 << j)`` in round
    ``j`` (bit j of ``owner ^ dest`` set).  Derived identically on every
    rank from :func:`plan_window`, so the assembled windows are
    byte-identical to the cyclic plan's by construction.  Pieces with
    ``owner == dest`` never enter the wire schedule."""
    if nprocs < 2 or nprocs & (nprocs - 1):
        raise ValueError(
            f"swing schedule requires a power-of-two process count >= 2, "
            f"got {nprocs}"
        )
    if nprocs > (1 << 15):
        raise ValueError(
            "swing round tags ride the low nibble-and-a-bit of the leg "
            f"tag byte — {nprocs} processes would overflow it"
        )
    block = n // nprocs  # plan_window validates divisibility
    nrounds = nprocs.bit_length() - 1
    rounds: list[dict[int, list]] = [{} for _ in range(nrounds)]
    for d in range(nprocs):
        start_d = (rel_start + d * block) % n
        for owner, glo, glen, woff in plan_window(start_d, block, n, nprocs):
            if owner == d:
                continue
            diff = owner ^ d
            h = owner
            for j in range(nrounds):
                if (diff >> j) & 1:
                    rounds[j].setdefault(h, []).append((d, owner, glo, glen, woff))
                    h ^= 1 << j
    return tuple(
        {h: tuple(sorted(v, key=lambda e: (e[0], e[4]))) for h, v in r.items()}
        for r in rounds
    )
