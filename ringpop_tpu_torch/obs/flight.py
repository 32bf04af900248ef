"""Crash flight recorder: a rank's last seconds, dumped post-mortem.

A rank that dies mid-sweep today leaves only whatever its journal had
flushed — and the journal cadence is sized for amortization (hundreds of
ticks per block), not forensics.  The :class:`FlightRecorder` keeps a
bounded in-memory ring of the MOST RECENT records crossing the
observability plane (telemetry block records, span records, stat/ops
events — anything dict-shaped) and writes them to a post-mortem JSONL
when the process is about to be useless:

* a fabric peer failure (``FabricPeerLost``/``FabricTimeout`` — the
  surviving side records what it saw the moment its peer vanished),
  via :func:`ringpop_tpu_torch.parallel.fabric.add_failure_hook`;
* an uncaught exception (``sys.excepthook`` / ``threading.excepthook``
  — the dying side's own last seconds).

The dump is one JSONL file: a ``kind:"flight_header"`` record (reason,
rank, pid, wall time, :func:`git_commit`, buffer bounds) followed by the
buffered records oldest-first — the same schema the live journals use,
so every existing journal reader parses it (OBSERVABILITY.md documents
the format).  Dumping is once-per-process by default (the FIRST failure
is the interesting one; later hooks re-dump only with ``force=True``)
and never raises — a broken disk must not mask the original crash.

torch-free: stdlib only.  :func:`git_commit` lives here (not in the
torch-importing ``sim/telemetry.py``) so both the flight header and the
telemetry journal header share one provenance probe.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Optional

from ringpop_tpu_torch.errors import FabricPeerLost, FabricTimeout

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def git_commit(repo: str = _REPO) -> Optional[str]:
    """The commit hash of the repo's HEAD, read straight from the
    ``.git`` directory (no subprocess — must work in minimal containers
    and never be slow): resolves ``HEAD`` through loose refs and
    ``packed-refs``.  None when the tree is not a git checkout — the
    journal header records that honestly rather than guessing."""
    git_dir = os.path.join(repo, ".git")
    try:
        # worktrees/submodules: .git may be a pointer file
        if os.path.isfile(git_dir):
            with open(git_dir) as f:
                line = f.read().strip()
            if line.startswith("gitdir:"):
                git_dir = os.path.normpath(
                    os.path.join(repo, line.split(":", 1)[1].strip())
                )
        # linked worktrees keep HEAD in their private gitdir but store
        # refs/packed-refs in the COMMON dir (named by `commondir`)
        common = git_dir
        common_file = os.path.join(git_dir, "commondir")
        if os.path.isfile(common_file):
            with open(common_file) as f:
                common = os.path.normpath(
                    os.path.join(git_dir, f.read().strip())
                )
        with open(os.path.join(git_dir, "HEAD")) as f:
            head = f.read().strip()
        if not head.startswith("ref:"):
            return head or None  # detached HEAD: the hash itself
        ref = head.split(":", 1)[1].strip()
        for base in (git_dir, common):
            loose = os.path.join(base, *ref.split("/"))
            if os.path.exists(loose):
                with open(loose) as f:
                    return f.read().strip() or None
        packed = os.path.join(common, "packed-refs")
        if os.path.exists(packed):
            with open(packed) as f:
                for line in f:
                    line = line.strip()
                    if line and not line.startswith(("#", "^")):
                        sha, _, name = line.partition(" ")
                        if name == ref:
                            return sha
        return None
    except OSError:
        return None


class FlightRecorder:
    """Bounded ring of recent observability records + post-mortem dump.

    ``capacity`` bounds memory (records are shallow-copied dicts; at the
    default 1024 a fleet block record ≈ 1 KB keeps the ring around a
    megabyte).  The recorder is itself a record sink — pass it wherever
    a ``TelemetrySink.fn``, a ``Tracer`` sink, or a stats hook takes a
    callable."""

    def __init__(
        self,
        capacity: int = 1024,
        *,
        rank: int = 0,
        path: Optional[str] = None,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.rank = rank
        # default landing spot: RINGPOP_FLIGHT_DIR or the cwd
        self.path = path or os.path.join(
            os.environ.get("RINGPOP_FLIGHT_DIR", "."),
            f"flight-rank{rank}-pid{os.getpid()}.jsonl",
        )
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._seq = 0
        # first dump path PER SCOPE: the engine's once-per-process dump
        # ("engine" — fabric failures, uncaught exceptions) must survive
        # a controller mitigation dumping first, so each scope gets its
        # own once-only slot and its own default filename
        self.dumps: dict[str, str] = {}
        self._installed: list = []

    @property
    def dumped(self) -> Optional[str]:
        """Path of the first ENGINE-scope dump (the once-per-process
        crash dump; controller-scope dumps do not consume it)."""
        return self.dumps.get("engine")

    # -- recording ------------------------------------------------------------

    def record(self, rec: dict) -> None:
        """Append one record (any dict with a ``kind``; missing kinds
        are stamped ``"event"``).  Never raises."""
        try:
            entry = {"kind": "event", **rec}
            with self._lock:
                entry["flight_seq"] = self._seq
                self._seq += 1
                self._ring.append(entry)
        except Exception:
            pass

    __call__ = record  # sink duck-type (Tracer sink / TelemetrySink.fn)

    def event(self, kind: str, **fields) -> None:
        self.record({"kind": kind, "t": time.time(), **fields})

    def records(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    @property
    def seq(self) -> int:
        return self._seq

    # -- dumping --------------------------------------------------------------

    def dump(
        self,
        reason: str,
        *,
        error: Optional[BaseException] = None,
        path: Optional[str] = None,
        force: bool = False,
        scope: str = "engine",
    ) -> Optional[str]:
        """Write the post-mortem JSONL; returns its path (None when a
        previous dump in the same ``scope`` already exists and ``force``
        is False, or on any write failure — never raises).  Dumping is
        once-per-process PER SCOPE: the default ``"engine"`` scope is
        the crash dump the fabric/excepthook triggers own; a failing
        controller mitigation dumps under ``scope="controller"`` with a
        ``-controller``-suffixed filename, leaving the engine dump
        unburned for a real fabric failure."""
        try:
            with self._lock:
                if scope in self.dumps and not force:
                    return None
                target = path or self.path
                if path is None and scope != "engine":
                    root, ext = os.path.splitext(self.path)
                    target = f"{root}-{scope}{ext}"
                records = list(self._ring)
                seq = self._seq
            header = {
                "kind": "flight_header",
                "reason": reason,
                "scope": scope,
                "error": None if error is None else (
                    f"{type(error).__name__}: {error}"
                ),
                "rank": self.rank,
                "pid": os.getpid(),
                "t": time.time(),
                "git_commit": git_commit(),
                "capacity": self.capacity,
                "records": len(records),
                "dropped": max(0, seq - len(records)),
            }
            tmp = f"{target}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(json.dumps(header, sort_keys=True) + "\n")
                for rec in records:
                    f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
            os.replace(tmp, target)
            with self._lock:
                self.dumps.setdefault(scope, target)
            return target
        except Exception:
            return None

    # -- hook installation -----------------------------------------------------

    def install(
        self,
        *,
        fabric: bool = True,
        excepthook: bool = True,
        threads: bool = True,
    ) -> "FlightRecorder":
        """Arm the dump triggers.  ``fabric`` registers with the DCN
        fabric's failure hooks (dump on ``FabricPeerLost``/
        ``FabricTimeout`` — the surviving rank's view of a dead peer);
        ``excepthook``/``threads`` chain the process hooks (the dying
        rank's own view), calling the PREVIOUS hook afterwards so
        default tracebacks still print."""
        if fabric:
            from ringpop_tpu_torch.parallel import fabric as _fabric

            def on_fabric(err: BaseException) -> None:
                if isinstance(err, (FabricPeerLost, FabricTimeout)):
                    self.dump(f"fabric:{type(err).__name__}", error=err)

            _fabric.add_failure_hook(on_fabric)
            self._installed.append(("fabric", on_fabric))
        if excepthook:
            prev = sys.excepthook

            def hook(etype, evalue, etb, _prev=prev):
                self.dump("uncaught_exception", error=evalue)
                _prev(etype, evalue, etb)

            sys.excepthook = hook
            self._installed.append(("excepthook", prev))
        if threads:
            prev_t = threading.excepthook

            def thook(args, _prev=prev_t):
                self.dump("uncaught_thread_exception", error=args.exc_value)
                _prev(args)

            threading.excepthook = thook
            self._installed.append(("threads", prev_t))
        return self

    def uninstall(self) -> None:
        """Undo :meth:`install` (tests; reverse order)."""
        for kind, obj in reversed(self._installed):
            if kind == "fabric":
                from ringpop_tpu_torch.parallel import fabric as _fabric

                _fabric.remove_failure_hook(obj)
            elif kind == "excepthook":
                sys.excepthook = obj
            elif kind == "threads":
                threading.excepthook = obj
        self._installed.clear()
