"""Stats reporter implementations for the CLI (counterpart of
``ringpop_tpu/cli/stats.py``, the same lines and datagrams; parity:
reference ``scripts/testpop/statter.go:48-59`` file-statsd adapter + UDP
statsd option ``scripts/testpop/testpop.go``).  Torch-free.

Both reporters own an OS resource (file handle / UDP socket) and support
``close()`` plus the context-manager protocol — the CLI entry points close
them on exit so long-lived testpop processes don't leak descriptors, and
``FileStats.close`` flushes so the tail of a run survives process exit.
``close`` is idempotent; post-close emits are dropped (stats must never
take the node down)."""

from __future__ import annotations

import socket
import threading
import time
from typing import Optional, TextIO

from ringpop_tpu_torch.options import StatsReporter

# the live plane's snapshot-able reporter (r20) lives with its endpoint
# in obs/ but is re-exported here next to its streaming siblings — the
# three of them are the CLI's reporter menu
from ringpop_tpu_torch.obs.aggregate import AggregatingStats  # noqa: F401


class FileStats(StatsReporter):
    """Timestamped stat lines to a file (parity: statter.go FileStatter)."""

    def __init__(self, path: str):
        self._f: Optional[TextIO] = open(path, "a", buffering=1)

    def _write(self, kind: str, key: str, value) -> None:
        if self._f is None or self._f.closed:
            return
        self._f.write(f"{time.time():.6f} {kind} {key} {value}\n")

    def incr(self, key: str, value: int = 1) -> None:
        self._write("count", key, value)

    def gauge(self, key: str, value: float) -> None:
        self._write("gauge", key, value)

    def timing(self, key: str, seconds: float) -> None:
        self._write("timing", key, seconds)

    def close(self) -> None:
        if self._f is None or self._f.closed:
            return
        self._f.flush()
        self._f.close()

    def __enter__(self) -> "FileStats":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class UDPStatsd(StatsReporter):
    """Plain statsd wire format over UDP, with multi-metric datagrams.

    Metrics coalesce into statsd multi-metric packets (newline-separated
    ``key:value|type`` lines in one datagram — the statsd wire spec's
    batching form): a burst like the sim plane's ~19-key block emission
    costs ONE datagram instead of 19.  The buffer flushes when the next
    line would overflow ``max_datagram`` (1432 = typical ethernet MTU
    minus IP+UDP headers, per the statsd guidance), when an emit arrives
    ``flush_s`` after the last flush, on explicit :meth:`flush`, and on
    :meth:`close` — so a quiet reporter's tail is bounded by the next
    emit or the owner's close, and a busy one batches every window.

    Hardened (r20): NO path raises mid-run — a dead/closed socket, an
    unresolvable host, or an OS send failure drops the metric (stats
    must never take the node down; the constructor still raises on a
    malformed hostport, which is a config error, not a runtime one)."""

    def __init__(
        self, hostport: str, *, max_datagram: int = 1432, flush_s: float = 0.25
    ):
        host, port = hostport.rsplit(":", 1)
        self._addr = (host, int(port))
        self.max_datagram = max_datagram
        self.flush_s = flush_s
        self._buf: list[bytes] = []
        self._buf_bytes = 0
        self._last_flush = 0.0  # epoch 0: the first emit flushes at once
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = socket.socket(
            socket.AF_INET, socket.SOCK_DGRAM
        )

    def _emit(self, line: str) -> None:
        data = line.encode()
        out: list = []
        with self._lock:
            sock = self._sock
            if sock is None:
                return  # post-close emits are dropped
            if self._buf and (
                self._buf_bytes + 1 + len(data) > self.max_datagram
            ):
                out.append(self._swap_locked())
            self._buf.append(data)
            self._buf_bytes += len(data) + (1 if len(self._buf) > 1 else 0)
            if time.time() - self._last_flush >= self.flush_s:
                out.append(self._swap_locked())
        self._send(out, sock)

    def _swap_locked(self) -> Optional[bytes]:
        """Detach the pending datagram (caller holds the lock).  The
        sendto happens AFTER the lock is released — a kernel send under
        the emit lock would stall every other emitting thread behind
        socket-buffer backpressure (RPH302)."""
        self._last_flush = time.time()
        if not self._buf:
            self._buf_bytes = 0
            return None
        payload = b"\n".join(self._buf)
        self._buf, self._buf_bytes = [], 0
        return payload

    def _send(self, payloads, sock) -> None:
        for payload in payloads:
            if payload is None:
                continue
            try:
                sock.sendto(payload, self._addr)
            except (OSError, ValueError):
                pass  # stats must never take the node down (dead socket incl.)

    def flush(self) -> None:
        with self._lock:
            sock = self._sock
            payload = self._swap_locked() if sock is not None else None
        if sock is not None:
            self._send([payload], sock)

    def incr(self, key: str, value: int = 1) -> None:
        self._emit(f"{key}:{value}|c")

    def gauge(self, key: str, value: float) -> None:
        self._emit(f"{key}:{value}|g")

    def timing(self, key: str, seconds: float) -> None:
        self._emit(f"{key}:{seconds * 1000:.3f}|ms")

    def close(self) -> None:
        with self._lock:
            sock, self._sock = self._sock, None
            payload = self._swap_locked() if sock is not None else None
        if sock is not None:
            self._send([payload], sock)
            try:
                sock.close()
            except OSError:
                pass

    def __enter__(self) -> "UDPStatsd":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
