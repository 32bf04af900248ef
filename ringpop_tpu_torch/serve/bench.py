"""Paired A/B driver: N frontend processes vs the shared device ring.

The measurement the serve tier exists for: F real OS processes drive
keyed lookups (A) through the shared device-resident ring service —
over the shared-memory request ring (``serve/shm.py``, the same-host
fast lane) or over TCP (``net/channel.py`` framing) — and (B) through
their own in-process host bisect walk, the exact lookup the host plane
does today.  Phases are INTERLEAVED rep by rep (serve, bisect, serve,
...) behind a cross-process barrier, the same pairing methodology as
``forward_ab``, so container-load drift hits both sides of each pair
equally.  Every (worker, rep) computes a fingerprint32 digest over its
owner-id stream + the membership generation that answered it; A/B
digests must match pairwise — owner decisions bit-identical per key and
per membership generation is the certificate, not an assumption.

Workers are ``spawn`` processes (no inherited device or asyncio state);
the service runs on a dedicated thread in the parent with its own event
loop.  Counterpart of ``ringpop_tpu/serve/bench.py`` with the port's
``RingStore`` on its device (``device=``; the card unless the caller asks
for the CPU).  Top-level imports here stay torch-free, and the workers
import only the torch-free host modules (``serve.client``, ``serve.shm``,
``net``, ``hashing``), so a frontend process never loads torch for itself
or creates a CUDA context.  (``spawn`` also re-imports the parent's main
script in each child, as Python does for every ``spawn`` process: a main
script that imports torch at its top level loads it there, but creates no
context.)
"""

from __future__ import annotations

import asyncio
import multiprocessing
import threading
import time
from typing import Optional


def _digest_owners(digest: int, owners, gen: int) -> int:
    """Chain a fingerprint32 over one batch's owner ids + generation."""
    from ringpop_tpu_torch.hashing import fingerprint32

    import numpy as np

    payload = (
        digest.to_bytes(4, "little")
        + np.asarray(owners, np.int32).tobytes()
        + int(gen).to_bytes(4, "little")
    )
    return fingerprint32(payload)


def _batch_hashes(seed: int, wid: int, rep: int, bi: int, batch: int):
    import numpy as np

    rng = np.random.default_rng(seed + wid * 1_000_003 + rep * 1009 + bi)
    return rng.integers(0, 2**32, size=batch, dtype=np.uint32)


def _measure_reps(
    wid: int, lookup, bisect_fe, gen: int, batch: int, batches_per_rep: int,
    reps: int, seed: int, barrier,
) -> list[dict]:
    """The shared inner loop: interleaved serve/bisect phases behind the
    barrier; per-(rep, mode) wall, key count and owner digest.

    The owner digest is chained after the phase's closing barrier, outside
    its wall: the port's host Fingerprint32 is the numpy copy, about twenty
    times slower over one batch's owners than the JAX package's native
    core, and would otherwise dominate both sides' timings.  The digests
    are the JAX package's values."""
    out = []
    for rep in range(reps):
        for mode in ("serve", "bisect"):
            barrier.wait()
            t0 = time.perf_counter()
            answers, keys = [], 0
            for bi in range(batches_per_rep):
                hashes = _batch_hashes(seed, wid, rep, bi, batch)
                if mode == "serve":
                    owners, g = lookup(hashes)
                else:
                    owners, g = bisect_fe.lookup_hashes(hashes), gen
                answers.append((owners, g))
                keys += len(hashes)
            wall = time.perf_counter() - t0
            barrier.wait()
            digest = 0
            for owners, g in answers:
                digest = _digest_owners(digest, owners, g)
            gens = {g for _, g in answers}
            out.append(
                dict(wid=wid, rep=rep, mode=mode, keys=keys,
                     wall=round(wall, 6), digest=digest, gens=sorted(gens))
            )
    return out


def _worker(
    wid: int,
    transport: str,
    address,
    servers: list[str],
    replica_points: int,
    gen: int,
    batch: int,
    batches_per_rep: int,
    reps: int,
    seed: int,
    codec: str,
    barrier,
    outq,
) -> None:
    """One frontend process (shm: synchronous slot client; tcp: asyncio
    channel client — both drive the same measurement loop)."""
    from ringpop_tpu_torch.serve.client import HostBisectFrontend

    bisect_fe = HostBisectFrontend(servers, replica_points)

    if transport == "shm":
        from ringpop_tpu_torch.serve.shm import ShmClient

        shm_name, sock_path, slots, key_cap, max_n = address
        client = ShmClient(
            shm_name, sock_path, wid, slots=slots, key_cap=key_cap, max_n=max_n
        )
        client.lookup_hashes(_batch_hashes(seed, wid, 0, 0, 8))  # warm path
        out = _measure_reps(
            wid, client.lookup_hashes, bisect_fe, gen, batch,
            batches_per_rep, reps, seed, barrier,
        )
        client.close()
        outq.put(out)
        return

    from ringpop_tpu_torch.net import TCPChannel
    from ringpop_tpu_torch.serve.client import ServeClient

    async def run():
        chan = TCPChannel(app="serve-fe", codec=codec)
        client = ServeClient(chan, address)
        # connection warm-up outside any timed phase
        await client.lookup_hashes(_batch_hashes(seed, wid, 0, 0, 8)[:1])

        def lookup(hashes):
            return loop.run_until_complete(client.lookup_hashes(hashes))

        loop = asyncio.get_event_loop()
        return lookup

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    lookup = loop.run_until_complete(run())
    out = _measure_reps(
        wid, lookup, bisect_fe, gen, batch, batches_per_rep, reps, seed, barrier
    )
    outq.put(out)


def _latency_worker(
    transport: str, address, servers, replica_points: int, n_req: int,
    codec: str, outq,
) -> None:
    """Single-frontend degenerate case: B=1 sequential round trips, every
    answer checked against the local bisect oracle ("routes correctly" is
    part of the certificate, not an assumption)."""
    from ringpop_tpu_torch.serve.client import HostBisectFrontend

    oracle = HostBisectFrontend(servers, replica_points)

    if transport == "shm":
        from ringpop_tpu_torch.serve.shm import ShmClient

        shm_name, sock_path, slots, key_cap, max_n = address
        client = ShmClient(
            shm_name, sock_path, 0, slots=slots, key_cap=key_cap, max_n=max_n
        )

        lat, ok = _time_latency(client.lookup_hashes, oracle, n_req)
        client.close()
        outq.put((lat, ok))
        return

    from ringpop_tpu_torch.net import TCPChannel
    from ringpop_tpu_torch.serve.client import ServeClient

    async def run():
        chan = TCPChannel(app="serve-lat", codec=codec)
        client = ServeClient(chan, address)

        def lookup(hashes):
            return loop.run_until_complete(client.lookup_hashes(hashes))

        return lookup

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    lookup = loop.run_until_complete(run())
    outq.put(_time_latency(lookup, oracle, n_req))


def _time_latency(lookup, oracle, n_req: int) -> tuple[list[float], bool]:
    import numpy as np

    hashes = np.arange(1, dtype=np.uint32)
    for _ in range(16):  # warm the path
        lookup(hashes)
    lat, ok = [], True
    for i in range(n_req):
        hashes[0] = np.uint32(i * 2654435761 % (2**32))
        t0 = time.perf_counter()
        owners, _g = lookup(hashes)
        lat.append(time.perf_counter() - t0)
        ok = ok and int(owners[0]) == int(oracle.lookup_hashes(hashes)[0])
    return sorted(lat), ok


class ServiceThread:
    """The shared ring service on its own thread + event loop, listening
    on TCP and (optionally) the shared-memory request ring."""

    def __init__(self, store, *, codec: str = "json", max_batch: int = 8192,
                 flush_us: float = 0.0, inline_resolve_max: int = 4096,
                 journal=None, stats=None, journal_every: int = 64,
                 shm_slots: int = 0, shm_key_cap: int = 1 << 16,
                 shm_max_n: int = 4, ledger=None):
        from ringpop_tpu_torch.serve.service import RingService

        self.store = store
        # ledger: a shared TransportLedger — the TCP channel accounts as
        # class "rpc" and the shm ring as class "shm" in ONE place
        self.ledger = ledger
        self.service = RingService(
            store, max_batch=max_batch, flush_us=flush_us,
            inline_resolve_max=inline_resolve_max, journal=journal,
            stats=stats, journal_every=journal_every,
        )
        self._codec = codec
        self._shm_slots = shm_slots
        self._shm_key_cap = shm_key_cap
        self._shm_max_n = shm_max_n
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()
        self.hostport: Optional[str] = None
        self.shm_server = None
        self.channel = None
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        from ringpop_tpu_torch.net import TCPChannel

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop
        chan = TCPChannel(app="serve", codec=self._codec, ledger=self.ledger)
        self.channel = chan

        async def boot():
            await chan.listen("127.0.0.1", 0)
            self.service.attach(chan)
            self.hostport = chan.hostport
            if self._shm_slots:
                from ringpop_tpu_torch.serve.shm import ShmServer

                self.shm_server = ShmServer(
                    self.service, slots=self._shm_slots,
                    key_cap=self._shm_key_cap, max_n=self._shm_max_n,
                    ledger=self.ledger,
                )
                self.shm_server.attach(loop)
            self._started.set()

        loop.run_until_complete(boot())
        try:
            loop.run_forever()
        finally:
            if self.shm_server is not None:
                self.shm_server.close()
            loop.run_until_complete(chan.close())
            loop.close()

    def start(self) -> str:
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("serve service thread failed to start")
        return self.hostport

    def shm_address(self):
        name, sock = self.shm_server.address
        return (name, sock, self._shm_slots, self._shm_key_cap, self._shm_max_n)

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=10)


def run_ab(
    *,
    n_servers: int = 64,
    replica_points: int = 100,
    frontends: int = 4,
    batch: int = 4096,
    batches_per_rep: int = 8,
    reps: int = 3,
    warm_reps: int = 1,
    seed: int = 0,
    transport: str = "shm",
    codec: str = "json",
    flush_us: Optional[float] = None,
    max_batch: int = 65536,
    inline_resolve_max: int = 65536,
    latency_reqs: int = 200,
    journal=None,
    stats=None,
    placement: str = "random",
    device=None,
) -> dict:
    """The full paired A/B: returns the simbench-ready record payload.
    The store lives on ``device`` (the card by default)."""
    import numpy as np
    import torch

    from ringpop_tpu_torch.serve.state import RingStore, serve_lookup, serve_lookup_fused

    if transport not in ("shm", "tcp"):
        raise ValueError(f"unknown transport {transport!r}")
    if placement != "random":
        # the bisect baseline and the post-update oracle answer from the
        # REFERENCE placement (HostBisectFrontend builds a default ring),
        # so a DGRO-placed device ring would fail the bit-identity
        # certificate by construction — DGRO quality is scored by the
        # placement report (simbench serve_ring), not by this A/B
        raise ValueError(
            "run_ab certifies against the reference placement; "
            f"placement={placement!r} would mis-certify a correct system"
        )
    if flush_us is None:
        # shm coalesces structurally (one slot scan picks up every posted
        # frontend), so it flushes on the next loop iteration; tcp needs
        # the latency trigger to collect requests still in flight
        flush_us = 0.0 if transport == "shm" else 200.0
    servers = [f"10.8.{i // 256}.{i % 256}:3000" for i in range(n_servers)]
    store = RingStore(
        servers, replica_points=replica_points, placement=placement, device=device
    )
    dev = store.torch_device
    thread = ServiceThread(
        store, codec=codec, max_batch=max_batch, flush_us=flush_us,
        inline_resolve_max=inline_resolve_max, journal=journal, stats=stats,
        shm_slots=max(frontends, 1) if transport == "shm" else 0,
        shm_key_cap=max(1 << 16, batch),
    )
    hostport = thread.start()
    address = thread.shm_address() if transport == "shm" else hostport
    total_reps = warm_reps + reps
    try:
        # -- pre-warm the bounded pow-of-2 dispatch shape set -----------------
        # (the collector pads every coalesced flush to the next power of
        # two; a first launch at a new shape — the caching allocator's
        # first blocks, searchsorted's workspace — would otherwise land
        # inside a measured rep).  Warm the FUSED lookup: that is what the
        # collector's n=1 flushes dispatch.
        ring, gen0, _ = store.snapshot()
        size = 1
        while size <= min(frontends * batch * 2, max_batch):
            serve_lookup_fused(ring, torch.zeros(size, dtype=torch.int64, device=dev)).cpu()
            size *= 2

        # -- direct-dispatch latency baseline (in-process, B=1) --------------
        one = np.zeros(1, np.uint32)
        direct = []
        for i in range(max(latency_reqs, 32)):
            one[0] = np.uint32(i * 2654435761 % (2**32))
            t0 = time.perf_counter()
            owners, _g = serve_lookup(ring, torch.from_numpy(one.astype(np.int64)).to(dev))
            owners.cpu()
            if i >= 16:  # first calls warm the path
                direct.append(time.perf_counter() - t0)
        direct.sort()

        # -- the paired multi-process A/B ------------------------------------
        ctx = multiprocessing.get_context("spawn")
        barrier = ctx.Barrier(frontends + 1)
        outq = ctx.Queue()
        procs = [
            ctx.Process(
                target=_worker,
                args=(w, transport, address, servers, replica_points, gen0,
                      batch, batches_per_rep, total_reps, seed, codec,
                      barrier, outq),
            )
            for w in range(frontends)
        ]
        for p in procs:
            p.start()
        phase_walls: list[tuple[int, str, float]] = []
        for rep in range(total_reps):
            for mode in ("serve", "bisect"):
                barrier.wait()  # release the workers
                t0 = time.perf_counter()
                barrier.wait()  # all workers finished the phase
                phase_walls.append((rep, mode, time.perf_counter() - t0))
        results = [r for _ in procs for r in outq.get()]
        for p in procs:
            p.join(timeout=60)

        # -- reduce -----------------------------------------------------------
        keys_per_phase = frontends * batch * batches_per_rep
        agg = {}
        for rep, mode, wall in phase_walls:
            agg[(rep, mode)] = keys_per_phase / wall
        serve_qps = [agg[(r, "serve")] for r in range(warm_reps, total_reps)]
        bisect_qps = [agg[(r, "bisect")] for r in range(warm_reps, total_reps)]
        ratios = sorted(s / b for s, b in zip(serve_qps, bisect_qps))
        # the certificate: every (worker, rep) digest pair must match, and
        # every serve answer must have come from the pinned generation
        by_key = {}
        for r in results:
            by_key[(r["wid"], r["rep"], r["mode"])] = r
        digest_equal = all(
            by_key[(w, r, "serve")]["digest"] == by_key[(w, r, "bisect")]["digest"]
            for w in range(frontends)
            for r in range(total_reps)
        )
        gens = sorted(
            {g for r in results if r["mode"] == "serve" for g in r["gens"]}
        )

        # -- single-frontend degenerate case (B=1 through the transport) ----
        lat_q = ctx.Queue()
        lp = ctx.Process(
            target=_latency_worker,
            args=(transport, address, servers, replica_points, latency_reqs,
                  codec, lat_q),
        )
        lp.start()
        lat, lat_correct = lat_q.get(timeout=120)
        lp.join(timeout=60)

        # -- live-update certification: owners re-certify per generation ----
        upd = store.update(add=["10.9.0.1:3000"])
        probe = _batch_hashes(seed, 99, 0, 0, 256)
        ring2, gen2, _ = store.snapshot()
        dev_owned, dev_gen = serve_lookup(ring2, torch.from_numpy(probe.astype(np.int64)).to(dev))
        dev_owned = dev_owned.cpu().numpy()
        from ringpop_tpu_torch.serve.client import HostBisectFrontend

        oracle2 = HostBisectFrontend(
            store.servers_at(gen2), replica_points
        ).lookup_hashes(probe)
        update_certified = bool(
            int(dev_gen.cpu()[0]) == gen2
            and gen2 == gen0 + 1
            and np.array_equal(dev_owned, oracle2)
        )

        t = thread.service.telemetry
        direct_p50 = direct[len(direct) // 2]
        lat_p50 = lat[len(lat) // 2]
        return {
            "transport": transport,
            "frontends": frontends,
            "n_servers": n_servers,
            "replica_points": replica_points,
            "batch": batch,
            "keys_per_rep_per_side": keys_per_phase,
            "codec": codec,
            "flush_us": flush_us,
            "max_batch": max_batch,
            "serve_qps_reps": sorted(round(q) for q in serve_qps),
            "bisect_qps_reps": sorted(round(q) for q in bisect_qps),
            "serve_qps_median": round(sorted(serve_qps)[len(serve_qps) // 2]),
            "bisect_qps_median": round(sorted(bisect_qps)[len(bisect_qps) // 2]),
            "ratio_reps": [round(r, 3) for r in ratios],
            "speedup_median": round(ratios[len(ratios) // 2], 3),
            "digest_equal": digest_equal,
            "generations_seen": gens,
            "generation_pinned": gens == [gen0],
            "update_certified": update_certified,
            "update_record": {
                k: upd[k] for k in ("gen", "n_servers", "count", "reallocated")
            } if upd else None,
            "latency_b1": {
                "direct_dispatch_p50_us": round(direct_p50 * 1e6, 1),
                "serve_p50_us": round(lat_p50 * 1e6, 1),
                "serve_p90_us": round(lat[int(len(lat) * 0.9)] * 1e6, 1),
                "ratio_p50": round(lat_p50 / direct_p50, 2),
                "owners_match_oracle": lat_correct,
            },
            "telemetry": {
                "flushes": t.flushes_total,
                "requests": t.requests_total,
                "keys": t.keys_total,
                "keys_per_flush_mean": round(
                    t.keys_total / max(t.flushes_total, 1), 1
                ),
            },
        }
    finally:
        thread.stop()
