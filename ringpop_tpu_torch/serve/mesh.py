"""Multi-host serve mesh: P serve processes, each owning a ring block.

Counterpart of ``ringpop_tpu/serve/mesh.py``.  Each rank's ring lives on
its device (the card by default; ranks that are threads of one process
share it), and its answers come from ``serve_lookup_n_fused``.  The wire
pieces are the JAX mesh's numpy dtypes — uint32 key hashes out, the int32
fused ``[B·n+1]`` vector back — so ``Fabric.wire_stats()`` counts the same
bytes.

The r13 serve tier scales FRONTENDS against one device-resident ring;
this module scales the serve tier itself: P serve processes each own a
contiguous block of the ring's token index space (the r14 partition
table's ``process_block`` rule — ``forward.batch.rank_of_hashes`` is the
key→rank map) and cross-forward mis-routed keys over the host-bridged
DCN fabric (``parallel/fabric.py``), so the whole mesh answers LookupN
preference lists at aggregate fan-in while every individual answer still
rides ONE fused device dispatch on the block owner.

Round structure (deterministic on every rank, the fabric contract):

1. each rank draws this round's key batch for the VIRTUAL STREAMS it
   hosts (streams are the workload unit: ``V`` streams exist at any P,
   stream ``s`` lives on rank ``s % P`` — so P∈{1,2,4} process the
   IDENTICAL total workload and the per-stream digests must agree);
2. request leg — keys are split by owning rank; every peer gets ONE
   coalesced request message per round (possibly empty — the schedule
   never depends on data), shipped via ``exchange_async`` so the local
   fused dispatch runs UNDER the inbound drain; message count per round
   is 2·(P-1) per rank regardless of key count — the O(owners), never
   O(keys), forwarding contract, priced in the returned records;
3. answer leg — the block owner answers local + forwarded keys through
   ``serve_lookup_n_fused`` (owners + generation, one transfer) and
   returns each peer's answers in one response message (the fused
   [B·n+1] vector verbatim — the generation travels with the owners);
4. every stream chains a fingerprint32 digest over (key hash, owner
   tuple, generation) in stream order.  At the end the per-stream
   digests allgather and combine in stream order — P-invariant by
   construction, so the P>1 mesh digest must equal the single-process
   oracle's bit-for-bit.  That equality is the certificate the simbench
   ``serve_fanin`` scenario and ``make serve-fanin-smoke`` assert.

Wire accounting comes straight off ``Fabric.wire_stats()`` (the r15
codec is available to every forwarded batch; random key hashes are
incompressible so the measured-raw fallback is the honest common case,
and the split wire/raw counters prove nothing is hidden).

Span tracing (r20): pass ``tracer=`` an ``obs.trace.Tracer`` and every
round's cross-forwarded batch emits ``mesh_request`` (sender side) and
``mesh_answer`` (owner side) spans for its sampled keys.  NO header
crosses the fabric — both sides derive the SAME trace and span ids from
the batch content + the deterministic (round, sender, owner) salt, so
the answer span's ``parent`` is computed, not propagated, and the
journal join works exactly as it does on the channel path.  Answer spans
carry ``gen``, joinable against the serve tier's ``ring_update``
records.  Host-plane only: digests are bit-identical tracer-on vs off
(pinned by ``tests/test_serve_mesh.py`` and the trace smoke).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device

from ringpop_tpu_torch.forward.batch import rank_of_hashes
from ringpop_tpu_torch.hashing import fingerprint32
from ringpop_tpu_torch.parallel.fabric import Fabric, LocalKV
from ringpop_tpu_torch.parallel.partition import process_block

# fabric tags: round in the high bits, leg in the low byte (the
# delta_multihost convention); the digest allgather keeps its own space
_TAG_REQ = 0x10
_TAG_RESP = 0x20
_TAG_DIGEST = 0x7FFF0000


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length() if x > 2 else max(int(x), 1)


def _stream_hashes(seed: int, stream: int, rnd: int, batch: int) -> np.ndarray:
    rng = np.random.default_rng(seed + stream * 1_000_003 + rnd * 1009)
    return rng.integers(0, 2**32, size=batch, dtype=np.uint32)


def _digest_chain(digest: int, hashes, owners, gen: int) -> int:
    payload = (
        digest.to_bytes(4, "little")
        + np.ascontiguousarray(hashes, np.uint32).tobytes()
        + np.ascontiguousarray(owners, np.int32).tobytes()
        + int(gen).to_bytes(4, "little", signed=False)
    )
    return fingerprint32(payload)


class ServeMesh:
    """One rank's endpoint of the serve mesh (thread- or process-hosted;
    the fabric's KV decides — LocalKV threads in tests and the chip smoke,
    a ``DistributedKV`` on a real multi-process job).  Its ring lives on
    ``device`` (the card by default)."""

    def __init__(
        self,
        rank: int,
        nprocs: int,
        servers: list[str],
        *,
        replica_points: int = 100,
        n: int = 3,
        streams: int = 4,
        seed: int = 0,
        kv=None,
        namespace: str = "serve-mesh",
        codec: bool = True,
        timeout_ms: int = 60_000,
        gen: int = 0,
        tracer=None,
        ledger=None,
        device: DeviceLike = None,
    ):
        if streams % nprocs:
            raise ValueError(
                f"streams={streams} must divide over {nprocs} ranks so every "
                "P processes the identical workload"
            )
        from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens
        from ringpop_tpu_torch.serve.state import device_ring

        self.device = resolve_device(device)
        self.rank, self.nprocs = rank, nprocs
        self.n = n
        self.seed = seed
        self.streams = streams
        self.my_streams = [s for s in range(streams) if s % nprocs == rank]
        self.n_servers = len(servers)
        toks, owns = build_ring_tokens(servers, replica_points, device="cpu")
        self.tokens = toks.numpy().astype(np.uint32)
        self.owners = owns.numpy().astype(np.int32)
        self.gen = gen
        count = int(self.tokens.shape[0])
        # the block this rank owns — the r14 equal-block rule over the
        # token index space (refuses non-divisible counts the same way)
        self.block = process_block(count, rank, nprocs)
        self.ring = device_ring(self.tokens, self.owners, _next_pow2(2 * count),
                                gen=gen, device=self.device)
        # r21: mesh exchange bytes account into the merged TransportLedger
        # under class "exchange"; pass a shared ledger for one cross-plane
        # byte view (wire_stats() keeps its legacy per-fabric shape)
        self.fabric = Fabric(
            rank, nprocs, kv if kv is not None else LocalKV(),
            namespace=namespace, codec=codec, timeout_ms=timeout_ms,
            ledger=ledger,
        )
        self.ledger = self.fabric.ledger
        self.tracer = tracer
        self.keys_local = 0
        self.keys_forwarded_out = 0
        self.keys_answered_for_peers = 0
        self.messages_sent = 0
        self._digests = {s: 0 for s in self.my_streams}

    # -- the fused local answer ----------------------------------------------

    def _answer(self, hashes: np.ndarray) -> np.ndarray:
        """int32[B, n] owner tuples for ``hashes`` through the fused
        device dispatch (pow-2 padded so the set of launch shapes is
        bounded, exactly like the serve tier's collector)."""
        from ringpop_tpu_torch.serve.state import serve_lookup_n_fused

        b = int(hashes.shape[0])
        if b == 0:
            return np.empty((0, self.n), np.int32)
        p2 = _next_pow2(b)
        padded = np.zeros(p2, np.uint32)
        padded[:b] = hashes
        keys = torch.from_numpy(padded.astype(np.int64)).to(self.device)
        fused = serve_lookup_n_fused(self.ring, self.n_servers, keys, self.n).cpu().numpy()
        if int(fused[-1]) != self.gen:
            # a hard raise, not an assert: this guards the digest
            # certificate itself (a ring/gen divergence here would embed
            # the same wrong generation in BOTH twin runs and pass the
            # equality check), so it must survive python -O
            raise RuntimeError(
                f"rank {self.rank}: device ring answered generation "
                f"{int(fused[-1])} but this rank is at {self.gen}"
            )
        return fused[: b * self.n].reshape(b, self.n)

    # -- one mesh round --------------------------------------------------------

    def round(self, rnd: int, keys_per_stream: int) -> None:
        """Draw, route, cross-forward, answer and digest one round."""
        peers = [p for p in range(self.nprocs) if p != self.rank]
        stream_hashes = {
            s: _stream_hashes(self.seed, s, rnd, keys_per_stream)
            for s in self.my_streams
        }
        # split every stream's keys by owning rank; remember positions so
        # answers reassemble in stream order
        sends: dict[int, list[np.ndarray]] = {p: [np.empty(0, np.uint32)] for p in peers}
        pending: dict[int, list[tuple[int, np.ndarray]]] = {p: [] for p in peers}
        local_parts: list[tuple[int, np.ndarray, np.ndarray]] = []
        for s, hashes in stream_hashes.items():
            ranks = rank_of_hashes(self.tokens, hashes, self.nprocs)
            mine = ranks == self.rank
            if mine.any():
                local_parts.append((s, np.flatnonzero(mine), hashes[mine]))
            for p in peers:
                ix = np.flatnonzero(ranks == p)
                if ix.size:
                    pending[p].append((s, ix))
        for p in peers:
            if pending[p]:
                sends[p] = [
                    np.concatenate(
                        [stream_hashes[s][ix] for s, ix in pending[p]]
                    ).astype(np.uint32)
                ]
        # mesh_request spans for sampled keys in each outbound batch —
        # begun BEFORE the exchange so the span times the full
        # frontend → owner → answer round trip; ids are pure functions
        # of (content, rnd, sender, dest), so the owner derives them
        # without any header crossing the fabric
        req_spans: dict[int, object] = {}
        if self.tracer is not None:
            from ringpop_tpu_torch.obs.trace import salt_of

            for p in peers:
                batch = sends[p][0]
                if batch.shape[0]:
                    sp = self.tracer.begin(
                        "mesh_request", batch,
                        salt=salt_of("mesh", rnd, self.rank, p),
                        rank=self.rank, dest=p, rnd=rnd,
                    )
                    if sp is not None:
                        req_spans[p] = sp
        tag_req = (rnd << 8) | _TAG_REQ
        h_req = self.fabric.exchange_async(tag_req, sends, peers)
        self.messages_sent += len(peers)
        self.keys_forwarded_out += sum(int(a[0].shape[0]) for a in sends.values())

        # the local fused dispatch runs while the request leg drains
        answers: dict[int, np.ndarray] = {
            s: np.full((keys_per_stream, self.n), -1, np.int32)
            for s in self.my_streams
        }
        gens: dict[int, np.ndarray] = {
            s: np.full(keys_per_stream, self.gen, np.int32)
            for s in self.my_streams
        }
        for s, ix, hashes in local_parts:
            rows = self._answer(hashes)
            answers[s][ix] = rows
            self.keys_local += int(hashes.shape[0])

        got = h_req.wait(join_sends=False)
        # answer every peer's forwarded batch — ONE fused dispatch per
        # peer, the response is the fused vector verbatim (gen rides it)
        resp: dict[int, list[np.ndarray]] = {}
        for p in peers:
            req = got[p][0]
            b = int(req.shape[0])
            self.keys_answered_for_peers += b
            if b == 0:
                resp[p] = [np.empty(0, np.int32)]
                continue
            answer_span = None
            if self.tracer is not None:
                from ringpop_tpu_torch.obs.trace import (
                    salt_of,
                    span_id_of,
                    trace_id_of,
                )

                keys = self.tracer.sampled_keys(np.asarray(req, np.uint32))
                if keys.size:
                    # the parent is the SENDER's mesh_request span id,
                    # derived (not propagated): same trace, the sender's
                    # (rnd, src=p, dest=me) salt
                    trace = trace_id_of(int(keys[0]))
                    answer_span = self.tracer.begin(
                        "mesh_answer", np.asarray(req, np.uint32),
                        parent=span_id_of(
                            trace, "mesh_request",
                            salt_of("mesh", rnd, p, self.rank),
                        ),
                        salt=salt_of("mesha", rnd, self.rank, p),
                        rank=self.rank, src=p, rnd=rnd,
                    )
            rows = self._answer(np.asarray(req, np.uint32))
            if answer_span is not None:
                answer_span.finish(gen=self.gen, answered=b)
            resp[p] = [
                np.concatenate(
                    [rows.reshape(-1), np.asarray([self.gen], np.int32)]
                )
            ]
        tag_resp = (rnd << 8) | _TAG_RESP
        h_resp = self.fabric.exchange_async(tag_resp, resp, peers)
        self.messages_sent += len(peers)
        got_resp = h_resp.wait(join_sends=False)
        for p in peers:
            vec = got_resp[p][0]
            if vec.shape[0] == 0:
                if pending[p]:
                    raise RuntimeError(
                        f"rank {self.rank}: peer {p} answered 0 keys for a "
                        f"non-empty forwarded batch"
                    )
                continue
            peer_gen = int(vec[-1])
            rows = np.asarray(vec[:-1], np.int32).reshape(-1, self.n)
            sp = req_spans.get(p)
            if sp is not None:
                sp.finish(gen=peer_gen, answered=rows.shape[0])
            off = 0
            for s, ix in pending[p]:
                answers[s][ix] = rows[off : off + ix.size]
                gens[s][ix] = peer_gen
                off += ix.size
        # chain the per-stream digests: (hashes, owner tuples, gen) in
        # stream order — the P-invariant certificate payload
        for s in self.my_streams:
            g = int(gens[s][0]) if keys_per_stream else self.gen
            if keys_per_stream and not (gens[s] == g).all():
                raise RuntimeError(
                    f"rank {self.rank}: stream {s} answered from mixed "
                    f"generations {sorted(set(gens[s].tolist()))}"
                )
            self._digests[s] = _digest_chain(
                self._digests[s], stream_hashes[s], answers[s], g
            )

    # -- the run + certificate -------------------------------------------------

    def run(self, rounds: int, keys_per_stream: int) -> dict:
        t0 = time.perf_counter()
        for rnd in range(rounds):
            self.round(rnd, keys_per_stream)
        wall = time.perf_counter() - t0
        # every stream's digest, allgathered and combined in stream order
        mine = np.asarray(
            [[s, self._digests[s]] for s in self.my_streams], np.uint32
        ).reshape(len(self.my_streams), 2)
        gathered = self.fabric.allgather(_TAG_DIGEST, mine)
        by_stream = {}
        for block in gathered:
            for s, d in np.asarray(block, np.uint32).reshape(-1, 2):
                by_stream[int(s)] = int(d)
        combined = fingerprint32(
            b"".join(
                by_stream[s].to_bytes(4, "little") for s in range(self.streams)
            )
        )
        keys_total = len(self.my_streams) * rounds * keys_per_stream
        return {
            "rank": self.rank,
            "nprocs": self.nprocs,
            "rounds": rounds,
            "streams": self.my_streams,
            "digest": combined,
            "stream_digests": by_stream,
            "wall_s": round(wall, 4),
            "keys_total": keys_total,
            "keys_per_s": round(keys_total / max(wall, 1e-9)),
            "keys_local": self.keys_local,
            "keys_forwarded_out": self.keys_forwarded_out,
            "keys_answered_for_peers": self.keys_answered_for_peers,
            "messages_sent": self.messages_sent,
            # O(owners) pricing: the naive plane ships one message per
            # forwarded KEY; the mesh ships 2(P-1) per round per rank
            "messages_naive": 2 * self.keys_forwarded_out,
            "wire": self.fabric.wire_stats(),
        }

    def close(self) -> None:
        self.fabric.close()


def run_serve_mesh(
    nprocs: int,
    *,
    n_servers: int = 16,
    replica_points: int = 100,
    n: int = 3,
    streams: int = 4,
    rounds: int = 4,
    keys_per_stream: int = 2048,
    seed: int = 0,
    codec: bool = True,
    namespace: Optional[str] = None,
    trace_sink=None,
    trace_sample: int = 64,
    device: DeviceLike = None,
) -> list[dict]:
    """Drive a P-rank serve mesh on LocalKV threads (the same fabric code
    paths real OS processes run), every rank's ring on ``device`` (the card
    by default), and return the per-rank records.  The caller asserts the certificate:
    every rank's combined digest equal, and equal to the P=1 oracle's."""
    import threading

    if streams % nprocs:
        raise ValueError(
            f"streams={streams} must divide over {nprocs} ranks so every "
            "P processes the identical workload"
        )
    dev = resolve_device(device)
    servers = [f"10.21.{i // 256}.{i % 256}:3000" for i in range(n_servers)]
    kv = LocalKV()
    ns = namespace or f"serve-mesh-{nprocs}-{seed}"
    out: list[Optional[dict]] = [None] * nprocs
    errs: list[Optional[BaseException]] = [None] * nprocs

    def worker(rank: int) -> None:
        mesh = None
        try:
            tracer = None
            if trace_sink is not None:
                from ringpop_tpu_torch.obs.trace import Tracer

                # one Tracer per rank (rank stamped on every span); the
                # sink must be thread-safe — JsonlSink locks, lists
                # under the test harness are append-only per CPython
                tracer = Tracer(trace_sink, sample=trace_sample, rank=rank)
            mesh = ServeMesh(
                rank, nprocs, servers, replica_points=replica_points, n=n,
                streams=streams, seed=seed, kv=kv, namespace=ns, codec=codec,
                tracer=tracer, device=dev,
            )
            out[rank] = mesh.run(rounds, keys_per_stream)
        except BaseException as e:  # noqa: BLE001 - surfaced to the caller
            errs[rank] = e
        finally:
            if mesh is not None:
                mesh.close()

    threads = [
        threading.Thread(target=worker, args=(r,), name=f"serve-mesh-{r}")
        for r in range(nprocs)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for r, e in enumerate(errs):
        if e is not None:
            raise RuntimeError(f"serve-mesh rank {r} failed") from e
    if any(rec is None for rec in out):
        raise RuntimeError("serve-mesh worker hung")
    return out  # type: ignore[return-value]
