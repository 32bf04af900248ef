"""LiveOps: the per-rank pull endpoint of the live operations plane.

One :class:`LiveOps` per rank bundles the plane's moving parts — an
:class:`~ringpop_tpu_torch.obs.aggregate.AggregatingStats` fed by both stat
planes, an optional :class:`~ringpop_tpu_torch.obs.flight.FlightRecorder`,
sweep progress state — and serves them over a pull-based HTTP endpoint
(stdlib ``http.server`` on a daemon thread; Prometheus scrapes it, a
human curls it):

* ``/metrics``  — Prometheus text exposition of every counter/gauge/
  timing this rank holds; on rank 0 of a multi-rank job the samples of
  EVERY rank (rank-labeled) plus unlabeled cross-rank aggregates.
* ``/healthz``  — JSON liveness: rank, uptime, and — on rank 0 — the
  seconds since each peer rank's last snapshot (a dead rank's age grows
  and its ``live`` flag drops; the scrape-side alert primitive).
* ``/progress`` — JSON sweep progress: ``ticks_done``/``horizon``/
  ``last_checkpoint_tick`` per rank — the "is the week-long sweep still
  moving" question answered without touching the job.

Cross-rank aggregation rides the fabric's tagged-message demux — the
same deterministic-round transport the engines use, on its OWN
:class:`~ringpop_tpu_torch.parallel.fabric.Fabric` (namespace ``"obs"``), so
the engines' wire/raw byte accounting and codec streams are untouched.
Every rank calls :meth:`sync` at the same protocol point (a journal
block boundary — ``FleetSweep`` does this automatically); non-zero
ranks enqueue their snapshot toward rank 0 and return WITHOUT waiting
(the drain rides the fabric's persistent sender threads), rank 0
enqueues tagged receive expectations and harvests whatever has landed —
``sync`` never blocks on a slow or dead peer.  The ops plane must never
take the run down: any fabric failure marks the plane degraded and is
swallowed (the flight recorder, if armed, has already captured it).

torch-free imports (``parallel.fabric`` is numpy-only and loaded lazily);
safe for serve frontends.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Optional

import numpy as np

from ringpop_tpu_torch.obs.aggregate import AggregatingStats, render_prometheus

# obs rounds live far above the engine tag spaces (delta legs are
# tick<<8|leg, the serve mesh uses rnd<<8|0x10/0x20 and 0x7FFF0000 for
# digests); they are also on their OWN fabric, so this is belt and braces
_TAG_OBS = 0x7FE0_0000

# a rank whose last snapshot is older than this many seconds reports
# live=false on /healthz (rank 0 only sees peers at sync cadence, so the
# caller should size it to a few journal blocks)
DEFAULT_STALE_S = 60.0


class LiveOps:
    """One rank's live-operations endpoint + cross-rank collector.

    Single-rank (``nprocs == 1`` or ``kv is None``): just the local
    stats/progress over HTTP.  Multi-rank: pass the job's coordination
    KV (``LocalKV`` for threaded twins, ``DistributedKV`` on a real
    job) and every rank must construct its ``LiveOps`` — the obs fabric
    rendezvous is collective, like any fabric bring-up."""

    def __init__(
        self,
        rank: int = 0,
        nprocs: int = 1,
        *,
        stats: Optional[AggregatingStats] = None,
        recorder=None,
        kv=None,
        namespace: str = "obs",
        timeout_ms: int = 3_600_000,
        stale_s: float = DEFAULT_STALE_S,
        ledger=None,
        rejoin: bool = False,
    ):
        self.rank, self.nprocs = rank, nprocs
        # r21: snapshot traffic accounts into the merged TransportLedger
        # under class "obs" — pass the job's shared ledger to get one
        # cross-plane byte view, or leave None for a private one
        self.ledger = ledger
        self.stats = stats if stats is not None else AggregatingStats()
        self.recorder = recorder
        self.stale_s = stale_s
        self.started = time.time()
        self.progress_state: dict = {
            "ticks_done": 0,
            "horizon": 0,
            "last_checkpoint_tick": None,
        }
        self._lock = threading.Lock()
        self._seq = 0
        self._degraded: Optional[str] = None
        # rank 0: peer snapshots {rank: {"t_recv", "snap", "progress"}}
        self._peers: dict[int, dict] = {}
        self._pending: list = []  # rank 0: (seq, ExchangeHandle, epochs)
        self._dead: set[int] = set()
        # rank-restart support: a rank that died and came back under the
        # same rank id constructs LiveOps(..., rejoin=True) — its fabric
        # advertises a rejoin listener instead of redoing bring-up, and
        # rank 0 dials dead peers' adverts from sync().  _epoch counts
        # link incarnations per peer so a failure on a pre-reconnect
        # round can't re-mark the fresh link dead; _adopted gates the
        # restarted rank's seq adoption from the dial's token.
        self._rejoin = rejoin
        self._adopted = not rejoin
        self._epoch: dict[int, int] = {}
        self._server = None
        self._server_thread = None
        self.fabric = None
        if kv is not None and nprocs > 1:
            from ringpop_tpu_torch.parallel.fabric import Fabric

            # a LONG timeout (default 1 h) + notify_failures=False:
            # sweep ranks sync at their own block cadence, so minutes of
            # skew (uneven slices, a checkpoint save) are ROUTINE on
            # this side channel — they must neither mark a progressing
            # peer dead nor burn the flight recorder's once-per-process
            # dump (that hook exists for ENGINE fabric failures; a dead
            # peer still surfaces here promptly as FabricPeerLost when
            # its socket closes, and as a growing /healthz age always)
            self.fabric = Fabric(
                rank, nprocs, kv, namespace=namespace,
                timeout_ms=timeout_ms, codec=True, notify_failures=False,
                ledger=ledger, ledger_class="obs", rejoin=rejoin,
            )
            self.ledger = self.fabric.ledger

    # -- progress + record ingestion ------------------------------------------

    def progress(
        self,
        ticks_done: int,
        horizon: int,
        last_checkpoint_tick: Optional[int] = None,
    ) -> None:
        """Update this rank's sweep progress (``FleetSweep`` calls this
        per journal block); mirrored into gauges so ``/metrics`` carries
        it too."""
        with self._lock:
            self.progress_state["ticks_done"] = int(ticks_done)
            self.progress_state["horizon"] = int(horizon)
            if last_checkpoint_tick is not None:
                self.progress_state["last_checkpoint_tick"] = int(
                    last_checkpoint_tick
                )
        self.stats.gauge("ringpop.obs.progress.ticks-done", ticks_done)
        self.stats.gauge("ringpop.obs.progress.horizon", horizon)
        if last_checkpoint_tick is not None:
            self.stats.gauge(
                "ringpop.obs.progress.last-checkpoint-tick",
                last_checkpoint_tick,
            )

    def block_record(self, record: dict) -> None:
        """Ingest one fetched telemetry block record: into the flight
        recorder ring and — via the sim plane's own key table — into the
        aggregated counters ``/metrics`` serves.  The telemetry import
        is lazy at CALL time (records only exist where torch already is;
        module import stays torch-free)."""
        if self.recorder is not None:
            # fetched records are kind-less until a journal stamps them;
            # the flight ring uses the same vocabulary
            self.recorder({"kind": "block", **record})
        try:
            from ringpop_tpu_torch.sim.telemetry import emit_stats

            emit_stats(self.stats, record)
        except Exception:
            pass  # the ops plane never takes the run down

    # -- cross-rank sync (the fabric-tagged collector) -------------------------

    def _payload(self) -> np.ndarray:
        body = {
            "t": time.time(),
            "snap": self.stats.snapshot(),
            "progress": dict(self.progress_state),
        }
        return np.frombuffer(
            json.dumps(body).encode("utf-8"), dtype=np.uint8
        ).copy()

    def sync(self) -> None:
        """One obs round — call at the SAME protocol point on every rank
        (a journal block boundary).  Non-blocking: rank > 0 enqueues its
        snapshot toward rank 0 (the drain rides the persistent sender
        threads; a sticky failure surfaces at the next enqueue and
        degrades the plane, never the run), rank 0 enqueues the round's
        receive expectations and harvests any completed earlier rounds."""
        if self.fabric is None or self._degraded is not None:
            return
        if self.rank != 0 and not self._adopted:
            # rejoining rank: no link until rank 0 dials our advert —
            # skip the round entirely (consuming seqs while link-less
            # would desync the tag sequence we're about to adopt)
            if not self.fabric.has_link(0):
                return
            self._seq = self.fabric.rejoin_token
            self._adopted = True
        if self.rank == 0 and self._dead:
            # dial any dead peer that has published a NEW rejoin advert;
            # token = the seq this very round will use, so the restarted
            # rank adopts the live tag sequence.  Per-peer try/except:
            # a failed dial is routine (peer still down), never degrades
            with self._lock:
                dead = sorted(self._dead)
            for peer in dead:
                try:
                    if self.fabric.reconnect_peer(peer, token=self._seq):
                        with self._lock:
                            self._epoch[peer] = self._epoch.get(peer, 0) + 1
                        if self.recorder is not None:
                            self.recorder(
                                {
                                    "kind": "obs_peer_rejoin",
                                    "peer": peer,
                                    "seq": self._seq,
                                    "t": time.time(),
                                }
                            )
                except Exception:
                    pass
        seq = self._seq
        self._seq += 1
        tag = (_TAG_OBS + seq) & 0xFFFFFFFF
        try:
            if self.rank != 0:
                self.fabric.exchange_async(tag, {0: [self._payload()]}, [])
                return
            peers = [p for p in range(self.nprocs) if p != 0]
            h = self.fabric.exchange_async(tag, {}, peers)
            with self._lock:
                self._pending.append((seq, h, dict(self._epoch)))
        except Exception as e:  # ops must never kill the sweep
            self._degraded = f"{type(e).__name__}: {e}"
            return
        self._harvest()

    def _harvest(self) -> None:
        """Fold every COMPLETED pending obs round into the peer table
        (rank 0 only; called from sync and from the HTTP handlers so a
        scrape between syncs still sees the freshest landed data).
        Completed rounds are REMOVED from the pending list, never the
        list replaced wholesale — a sync() appending concurrently from
        the sweep thread must not lose its round to a racing scrape."""
        with self._lock:
            pending = list(self._pending)
        done: set[int] = set()
        for seq, h, epochs in pending:
            got = h.poll()
            if got is None:
                continue
            done.add(id(h))
            for peer, val in got.items():
                if isinstance(val, BaseException):
                    with self._lock:
                        # a round enqueued against a PRE-reconnect link
                        # incarnation fails when the old link shuts
                        # down — that must not re-mark the fresh link's
                        # peer dead (epoch bumped at reconnect)
                        if epochs.get(peer, 0) == self._epoch.get(peer, 0):
                            self._dead.add(peer)
                    if self.recorder is not None:
                        self.recorder(
                            {
                                "kind": "obs_peer_lost",
                                "peer": peer,
                                "seq": seq,
                                "error": f"{type(val).__name__}: {val}",
                                "t": time.time(),
                            }
                        )
                    continue
                try:
                    body = json.loads(bytes(val[0].tobytes()).decode("utf-8"))
                except Exception:
                    continue
                with self._lock:
                    prev = self._peers.get(peer)
                    # rounds can complete out of order; keep the newest
                    if prev is None or prev.get("seq", -1) < seq:
                        self._peers[peer] = {
                            "seq": seq,
                            "t_recv": time.time(),
                            "snap": body.get("snap", {}),
                            "progress": body.get("progress", {}),
                            "t_sent": body.get("t"),
                        }
                    self._dead.discard(peer)
        if done:
            with self._lock:
                self._pending = [
                    e for e in self._pending if id(e[1]) not in done
                ]

    # -- views ----------------------------------------------------------------

    def _mirror_ledger(self) -> None:
        """r23: mirror the shared TransportLedger's per-class / per-LANE
        rows into gauges so ``/metrics`` exposes the lane split (tcp vs
        shm bytes/frames, ``inline_completions``, ``coalesced_frames``)
        without a second scrape surface.  Gauge names:
        ``ringpop.transport.<class>.<lane>.<field>``."""
        led = self.ledger
        if led is None or not hasattr(led, "stats"):
            return
        try:
            st = led.stats()
        except Exception:
            return  # the ops plane never takes the run down
        for klass, row in st.get("classes", {}).items():
            for lane, lrow in (row.get("lanes") or {}).items():
                for field, v in lrow.items():
                    self.stats.gauge(
                        f"ringpop.transport.{klass}.{lane}."
                        f"{field.replace('_', '-')}",
                        v,
                    )
        self.stats.gauge(
            "ringpop.transport.copy-bytes", st.get("copy_bytes", 0)
        )

    def snapshots(self) -> dict[int, dict]:
        """{rank: stats snapshot} — self fresh, peers as last collected."""
        if self.rank == 0 and self.fabric is not None:
            self._harvest()
        self._mirror_ledger()
        out = {self.rank: self.stats.snapshot()}
        with self._lock:
            for peer, entry in self._peers.items():
                out[peer] = entry["snap"]
        return out

    def health(self) -> dict:
        now = time.time()
        if self.rank == 0 and self.fabric is not None:
            self._harvest()
        with self._lock:
            ranks = {
                str(self.rank): {"age_s": 0.0, "live": True, "self": True}
            }
            for peer, entry in self._peers.items():
                age = round(now - entry["t_recv"], 3)
                ranks[str(peer)] = {
                    "age_s": age,
                    "live": peer not in self._dead and age < self.stale_s,
                }
            for peer in self._dead:
                if str(peer) not in ranks:
                    ranks[str(peer)] = {"age_s": None, "live": False}
            if self.rank == 0:
                # a rank that wedged BEFORE its first sync never enters
                # _peers or _dead — it must read as not-live once the
                # grace window (one staleness period from start) passes,
                # not stay invisible while /healthz green-lights the job
                grace = (now - self.started) < self.stale_s
                for peer in range(self.nprocs):
                    if peer != self.rank and str(peer) not in ranks:
                        ranks[str(peer)] = {
                            "age_s": None, "live": grace, "pending": True,
                        }
            degraded = self._degraded
        return {
            "ok": all(r["live"] for r in ranks.values()) and degraded is None,
            "rank": self.rank,
            "nprocs": self.nprocs,
            "uptime_s": round(now - self.started, 3),
            "degraded": degraded,
            "ranks": ranks,
        }

    def progress_view(self) -> dict:
        if self.rank == 0 and self.fabric is not None:
            self._harvest()
        now = time.time()
        with self._lock:
            ranks = {str(self.rank): dict(self.progress_state)}
            for peer, entry in self._peers.items():
                ranks[str(peer)] = {
                    **entry["progress"],
                    "age_s": round(now - entry["t_recv"], 3),
                }
        return {"rank": self.rank, "nprocs": self.nprocs, "ranks": ranks}

    # -- HTTP -----------------------------------------------------------------

    def serve(self, port: int = 0, host: str = "127.0.0.1") -> str:
        """Start the endpoint on a daemon thread; returns ``host:port``
        (port 0 picks a free one — tests/smokes read it back here)."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        ops = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet: scrapes are not app logs
                pass

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        body = render_prometheus(ops.snapshots()).encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif path == "/healthz":
                        h = ops.health()
                        body = (json.dumps(h, sort_keys=True) + "\n").encode()
                        ctype = "application/json"
                    elif path == "/progress":
                        body = (
                            json.dumps(ops.progress_view(), sort_keys=True)
                            + "\n"
                        ).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except BrokenPipeError:
                    pass
                except Exception:
                    # a rendering bug answers 500; it must never
                    # propagate into the serving thread
                    try:
                        self.send_error(500)
                    except Exception:
                        pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._server_thread = threading.Thread(
            target=self._server.serve_forever,
            daemon=True,
            name=f"liveops-r{self.rank}",
        )
        self._server_thread.start()
        addr = self._server.server_address
        return f"{addr[0]}:{addr[1]}"

    def close(self) -> None:
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except Exception:
                pass
            self._server = None
        if self.fabric is not None:
            try:
                self.fabric.close()
            except Exception:
                pass
            self.fabric = None

    def __enter__(self) -> "LiveOps":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
