"""Batched forwarding plane: per-owner coalescing, hop-guarded, quorum reads.

Counterpart of ``ringpop_tpu/forward/batch.py``.

The scalar :class:`~ringpop_tpu_torch.forward.Forwarder` proxies ONE keyed
request per call (reference ``forward/forwarder.go`` parity).  At serve
fan-in that is the wrong unit: a frontend holding the wrong ring block
would pay one RPC per mis-routed KEY.  This module is the batch analog —
the reference forwarder's semantics (retry with backoff, the
``ringpop-forwarded`` loop breaker) applied to COALESCED per-owner
key-hash batches over the ``net/channel.py`` framing:

* :class:`BatchForwarder` — ships one batch to one destination with
  retry/backoff and a MAX-HOP guard (``ringpop-hops`` header: the batch
  plane's generalization of the binary forwarded header — a mis-routed
  batch may legitimately hop once mid-churn, a loop dies at
  ``max_hops``).  Array payloads ride ``encode_array`` (raw bytes under
  msgpack, base64 under JSON, or the fabric's self-describing r15 codec
  under ``codec="fabric"`` — see ``net.channel``), and per-RPC counters
  (``rpcs``/``keys_forwarded``/``retries``) make the O(owners)-not-
  O(keys) claim measurable.
* :class:`BlockRouter` — HandleOrForward for a block-owning frontend
  (the r14 ``process_block`` rule over the ring's token index space):
  keys whose ring walk starts inside the local block answer locally, the
  rest coalesce into per-owner batches — ONE forward RPC per owner per
  flush.  Doubles as the receive-side handler: a forwarded batch whose
  keys moved again re-forwards with the hop count incremented.
* :class:`QuorumReader` — replica reads on LookupN preference lists:
  each key's R replica owners come from the exact ``host_lookup_n``
  walk, reads coalesce per owner (one RPC per owner per wave), and a key
  acks at ``quorum_size(r)`` = ⌈(R+1)/2⌉ responses.  ``quorum_wave``
  returns per-key ack counts + agreement, so a FaultPlan killing owners
  mid-read (``sim/chaos.py``) is scored — recovery rides
  ``chaos.score_blocks`` over the wave journal.

Span tracing (r20, ``obs/trace.py``): every class takes an optional
``Tracer``.  A batch holding a sampled key (sampling is a pure function
of the key hash — reruns trace the same requests) carries the
``ringpop-trace`` header (trace id + parent span id) NEXT TO
``ringpop-hops``, and each leg — frontend route, per-owner forward RPC,
receive-side handle, quorum wave — emits a ``kind:"span"`` record whose
``hops`` field is exactly the hop count the header carried.  Tracing off
(the default) is the identical code path with zero records.

Top-level imports stay torch-free (frontends import this without starting
a device runtime; ``obs.trace`` is numpy+stdlib); the quorum chaos harness
imports ``sim.chaos`` and the ring construction lazily, and keeps its churn plan
on the CPU — the plan is host bookkeeping, read through
``chaos.up_at_host``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch.forward.forwarder import FORWARDED_HEADER
from ringpop_tpu_torch.net.channel import (
    CallError,
    RemoteError,
    decode_array,
    encode_array,
)
from ringpop_tpu_torch.obs.trace import TRACE_HEADER, salt_of

_logger = logging_mod.logger("forward.batch")

HOPS_HEADER = "ringpop-hops"
DEFAULT_MAX_HOPS = 4
# the reference's 3/6/12 s schedule is sized for a lone app request; a
# coalesced batch stalls every rider, so the batch plane retries fast by
# default (still caller-configurable, same shape as forwarder.Options)
DEFAULT_BATCH_RETRY_DELAYS = (0.05, 0.2, 0.8)


class MaxHopsExceededError(Exception):
    """A batch crossed ``max_hops`` forwards — a routing loop (two nodes
    that each believe the other owns the block), not transient churn."""


def quorum_size(r: int) -> int:
    """⌈(R+1)/2⌉ — the majority-ack bar for an R-replica read."""
    return (r + 2) // 2


def hop_count(headers: Optional[dict]) -> int:
    try:
        return int((headers or {}).get(HOPS_HEADER, 0))
    except (TypeError, ValueError):
        return 0


class BatchForwarder:
    """One coalesced key-hash batch to one destination, with the
    reference retry engine and the hop guard."""

    def __init__(
        self,
        channel,
        *,
        service: str = "serve",
        endpoint: str = "/lookup",
        max_retries: int = 2,
        retry_delays: Sequence[float] = DEFAULT_BATCH_RETRY_DELAYS,
        timeout: float = 3.0,
        max_hops: int = DEFAULT_MAX_HOPS,
        fabric_arrays: bool = False,
        tracer=None,
    ):
        self.channel = channel
        self.service = service
        self.endpoint = endpoint
        self.max_retries = max_retries
        self.retry_delays = tuple(retry_delays)
        self.timeout = timeout
        self.max_hops = max_hops
        # fabric_arrays: ship the hash batch through the fabric's r15
        # wire codec (net.channel encode_array(fabric=True)) — the
        # decoder is self-describing, so the unmodified serve endpoints
        # answer either lane
        self.fabric_arrays = fabric_arrays
        # tracer: an obs.trace.Tracer — batches holding a sampled key
        # carry the ringpop-trace header and emit a "forward" span per
        # RPC (None = tracing off, the bit-identical default)
        self.tracer = tracer
        self._codec = getattr(channel, "codec", "json")
        self.rpcs = 0
        self.keys_forwarded = 0
        self.retries = 0
        self.batches_failed = 0

    def stats(self) -> dict:
        return {
            "rpcs": self.rpcs,
            "keys_forwarded": self.keys_forwarded,
            "retries": self.retries,
            "batches_failed": self.batches_failed,
        }

    async def forward_batch(
        self, dest: str, hashes, n: int = 1, hops: int = 0, parent=None,
        salt: int = 0,
    ):
        """-> (owners int32[B] or int32[B, n], generation).  ``hops`` is
        how many forwards this batch has ALREADY crossed; the guard fires
        before the wire so a loop costs ``max_hops`` RPCs total, not a
        timeout storm.  ``parent`` (a span id) parents this RPC's span
        when a tracer is attached and the batch holds a sampled key."""
        if hops >= self.max_hops:
            raise MaxHopsExceededError(
                f"batch of {len(hashes)} keys crossed {hops} forwards "
                f"(max_hops={self.max_hops}) — routing loop"
            )
        headers = {FORWARDED_HEADER: "true", HOPS_HEADER: str(hops + 1)}
        span = None
        if self.tracer is not None:
            # the span's hops field is EXACTLY the ringpop-hops value on
            # the wire — the acceptance join checks that equality
            span = self.tracer.begin(
                "forward", hashes, parent=parent, hops=hops + 1,
                salt=salt_of(dest, hops + 1, salt), dest=dest,
                endpoint=self.endpoint, n=n,
            )
            if span is not None:
                headers[TRACE_HEADER] = span.header_value()
        body = {
            "h": encode_array(
                hashes, self._codec, "<u4", fabric=self.fabric_arrays
            ),
            "n": n,
        }
        attempt = 0
        while True:
            try:
                self.rpcs += 1
                res = await self.channel.call(
                    dest, self.service, self.endpoint, body,
                    headers=headers, timeout=self.timeout,
                )
                break
            except RemoteError as e:
                # the remote HANDLER executed and raised (e.g. a deeper
                # hop guard): deterministic, and retrying would multiply
                # every hop level's RPCs by the retry count — a routing
                # loop must cost max_hops RPCs total, not 3^max_hops
                self.batches_failed += 1
                if span is not None:
                    span.finish(ok=False, retries=attempt, error=str(e))
                raise
            except CallError as e:
                if attempt >= self.max_retries:
                    self.batches_failed += 1
                    if span is not None:
                        span.finish(ok=False, retries=attempt, error=str(e))
                    raise
                delay = self.retry_delays[min(attempt, len(self.retry_delays) - 1)]
                attempt += 1
                self.retries += 1
                _logger.debug(
                    f"batch to {dest} failed ({e}); retry {attempt} in {delay}s"
                )
                await asyncio.sleep(delay)
        owners = decode_array(res["o"], "<i4")
        self.keys_forwarded += len(hashes)
        if n > 1:
            owners = owners.reshape(-1, n)
        # a BlockRouter handler answers with PER-KEY generations ("g") —
        # a re-forwarded (hops >= 2) batch can legitimately mix the
        # generations of several answerers mid-churn; plain serve
        # endpoints return the scalar "gen" (their whole answer came
        # from one snapshot)
        gens = decode_array(res["g"], "<i4") if "g" in res else int(res["gen"])
        if span is not None:
            g = gens if isinstance(gens, int) else (
                int(gens.max(initial=0)) if gens.size else 0
            )
            span.finish(ok=True, retries=attempt, gen=g)
        return owners, gens


def rank_of_hashes(tokens: np.ndarray, hashes, nprocs: int) -> np.ndarray:
    """Owner RANK per key hash under the contiguous equal-block rule the
    r14 partition table imposes (``parallel.partition.process_block``)
    applied to the ring's token INDEX space: the rank whose block holds
    the first token >= hash (wrapping to index 0).  ``len(tokens)`` must
    divide over ``nprocs`` — same rigidity, surfaced the same way."""
    count = int(tokens.shape[0])
    if count % nprocs:
        raise ValueError(
            f"ring of {count} tokens does not divide over {nprocs} serve "
            "processes (pick replica_points divisible by the process count)"
        )
    idx = np.searchsorted(tokens, np.asarray(hashes, np.uint32), side="left")
    idx = np.where(idx >= count, 0, idx)
    return (idx // (count // nprocs)).astype(np.int32)


def rank_load(tokens: np.ndarray, hashes, nprocs: int) -> np.ndarray:
    """Per-serve-process key-share histogram (length ``nprocs``) of a
    hash population under :func:`rank_of_hashes` — the load-skew signal
    the closed-loop rules engine watches (``obs/rules.py``
    CrossRankSkew gauges one rank's share against the fleet mean).
    Block shares renumber with the token count on membership changes,
    so drain EFFECTS are probed per server name (``lookup_batch``), not
    through this block view."""
    return np.bincount(
        rank_of_hashes(tokens, hashes, nprocs), minlength=nprocs
    ).astype(np.int64)


class BlockRouter:
    """HandleOrForward over ring blocks: the frontend-side (and
    receive-side) routing plane of the serve mesh's TCP flavor.

    ``local_lookup(hashes, n) -> (owners, gen)`` answers keys whose walk
    starts in this rank's block; everything else coalesces into ONE
    forwarded batch per owning rank.  The returned generation is per-key
    (cross-forwarded keys carry the remote answerer's generation — in a
    settled mesh all equal, and the fan-in certificate checks exactly
    that)."""

    def __init__(
        self,
        rank: int,
        nprocs: int,
        tokens_fn: Callable[[], np.ndarray],
        local_lookup,
        peer_addrs: Sequence[str],
        forwarder: BatchForwarder,
    ):
        if len(peer_addrs) != nprocs:
            raise ValueError(f"need one address per rank, got {len(peer_addrs)}")
        self.rank = rank
        self.nprocs = nprocs
        self.tokens_fn = tokens_fn  # () -> the CURRENT sorted live tokens
        self.local_lookup = local_lookup
        self.peer_addrs = list(peer_addrs)
        self.forwarder = forwarder
        self.keys_local = 0
        self.keys_forwarded = 0

    async def route(self, hashes, n: int = 1, hops: int = 0, parent=None):
        """-> (owners int32[B] or [B, n], gens int32[B]) in input order.
        ``gens`` is exact per key even across re-forwards — the handler
        ships the per-key array back, never a collapsed scalar.
        ``parent`` parents this route's span (a frontend call passes
        None; the receive-side handler passes its own span)."""
        hashes = np.asarray(hashes, np.uint32)
        b = hashes.shape[0]
        tracer = self.forwarder.tracer
        route_span = None
        if tracer is not None:
            route_span = tracer.begin(
                "route", hashes, parent=parent, hops=hops,
                salt=salt_of("route", self.rank, hops), rank=self.rank,
            )
        route_parent = None if route_span is None else route_span.span
        ranks = rank_of_hashes(self.tokens_fn(), hashes, self.nprocs)
        owners = np.full((b, n) if n > 1 else b, -1, np.int32)
        gens = np.full(b, -1, np.int32)
        local = ranks == self.rank
        if local.any():
            rows, gen = await _maybe_await(
                self.local_lookup(hashes[local], n)
            )
            owners[local] = rows
            gens[local] = gen
            self.keys_local += int(local.sum())
        remote_ranks = sorted(set(ranks[~local].tolist()))
        if remote_ranks:
            # one coalesced RPC per owning rank, issued concurrently
            groups = {r: np.flatnonzero(ranks == r) for r in remote_ranks}
            results = await asyncio.gather(
                *(
                    self.forwarder.forward_batch(
                        self.peer_addrs[r], hashes[ix], n=n, hops=hops,
                        parent=route_parent,
                    )
                    for r, ix in groups.items()
                )
            )
            for (r, ix), (rows, gen) in zip(groups.items(), results):
                owners[ix] = rows
                gens[ix] = gen
                self.keys_forwarded += len(ix)
        if route_span is not None:
            route_span.finish(
                keys_local=int(local.sum()),
                keys_forwarded=int((~local).sum()),
                owners=len(remote_ranks),
            )
        return owners, gens

    def handler(self):
        """A ``(service, endpoint)`` handler: answer a forwarded batch,
        re-forwarding keys that moved AGAIN with the hop count bumped
        (the loop guard lives in the forwarder)."""

        async def handle(body: dict, headers: dict) -> dict:
            hashes = decode_array(body["h"], "<u4")
            n = int(body.get("n", 1))
            hops = hop_count(headers)
            tracer = self.forwarder.tracer
            handle_span = None
            if tracer is not None:
                # traced iff the ringpop-trace header is present — the
                # sender made the sampling decision; the header's span
                # id (the sender's forward span) becomes the parent
                handle_span = tracer.follow(
                    headers, "handle", salt=salt_of("handle", self.rank, hops),
                    rank=self.rank, nkeys=int(hashes.shape[0]),
                )
            owners, gens = await self.route(
                hashes, n=n, hops=hops,
                parent=None if handle_span is None else handle_span.span,
            )
            if handle_span is not None:
                handle_span.finish(
                    gen=int(gens.max(initial=0)) if gens.size else 0
                )
            codec = getattr(self.forwarder.channel, "codec", "json")
            return {
                "o": encode_array(owners, codec, "<i4"),
                # per-key generations: a re-forwarded batch may mix the
                # generations of several answerers — collapsing to one
                # scalar here would stamp keys with a generation they
                # were NOT answered at; "gen" stays for plain-endpoint
                # schema compatibility (consumers of "g" ignore it)
                "g": encode_array(gens, codec, "<i4"),
                "gen": int(gens.max(initial=0)) if gens.size else 0,
            }

        return handle


async def _maybe_await(res):
    if asyncio.iscoroutine(res) or isinstance(res, asyncio.Future):
        return await res
    return res


# -- quorum replica reads -----------------------------------------------------


class QuorumReader:
    """R-replica reads over LookupN preference lists, coalesced per owner.

    This is the HASH-BATCH analog of the JAX package's ``replica.Replicator``
    (the reference-parity plane: string keys, opaque app bodies, one
    scalar ``Forwarder`` call per destination, explicit R/W thresholds).
    The grouping rule is the same as ``Replicator._group_replicas`` —
    every (key, replica) assignment groups by owning server, one RPC per
    destination per wave — but the unit is a uint32 hash batch over
    :class:`BatchForwarder`, the threshold is the majority bar
    ``quorum_size(r)`` = ⌈(R+1)/2⌉ rather than a free R value, and ack
    accounting is PER KEY (the chaos scorer consumes it).  A semantic
    change to either plane (grouping, ack policy) should be mirrored in
    the other — their docstrings cross-reference for exactly that
    reason.

    One wave = one batch of keys: each key's R unique replica owners come
    from the exact host walk (``ops.ring_ops.host_lookup_n`` — the
    LookupNUniqueAt parity oracle), every (key, replica) assignment
    groups by owning SERVER, and each owner gets ONE read RPC per wave
    carrying all its assigned keys.  A key acks once per owner that
    answered; success = acks >= ⌈(R+1)/2⌉ (``quorum_size``).  Answer
    agreement is part of the certificate: an acked key's responses must
    all carry the same owner id."""

    def __init__(
        self,
        forwarder: BatchForwarder,
        server_addrs: Sequence[str],
        *,
        r: int = 3,
    ):
        if r < 1:
            raise ValueError(f"r must be >= 1, got {r}")
        self.forwarder = forwarder
        self.server_addrs = list(server_addrs)
        self.r = r
        self.quorum = quorum_size(r)

    async def quorum_wave(
        self, tokens, owners, n_servers: int, hashes, parent=None,
        salt: int = 0,
    ) -> dict:
        """One read wave.  Returns the wave record: per-key ack counts,
        quorum/full-ack fractions, agreement, and the RPC count (the
        O(owners) pricing evidence).  With a traced forwarder, the wave
        emits a ``quorum_wave`` span parenting each per-owner read RPC —
        the quorum-read leg of the acceptance chain."""
        from ringpop_tpu_torch.ops.ring_ops import host_lookup_n

        hashes = np.asarray(hashes, np.uint32)
        b = hashes.shape[0]
        tracer = self.forwarder.tracer
        wave_span = None
        if tracer is not None:
            wave_span = tracer.begin(
                "quorum_wave", hashes, parent=parent,
                salt=salt_of("wave", salt), r=self.r, quorum=self.quorum,
            )
        wave_parent = None if wave_span is None else wave_span.span
        pref = host_lookup_n(tokens, owners, hashes, self.r, n_servers)  # [B, r]
        # group (key, replica) assignments by owning server
        by_owner: dict[int, list[int]] = {}
        for slot in range(self.r):
            for i in np.flatnonzero(pref[:, slot] >= 0):
                by_owner.setdefault(int(pref[i, slot]), []).append(int(i))
        acks = np.zeros(b, np.int32)
        answered: dict[int, list[np.ndarray]] = {i: [] for i in range(b)}

        async def read_one(owner: int, keys: list[int]):
            ix = np.asarray(keys, np.int64)
            try:
                rows, _gen = await self.forwarder.forward_batch(
                    self.server_addrs[owner], hashes[ix], n=1,
                    parent=wave_parent, salt=salt,
                )
            except (CallError, MaxHopsExceededError):
                return  # a dead/partitioned replica simply contributes no ack
            for k, row in zip(keys, np.asarray(rows, np.int32)):
                acks[k] += 1
                answered[k].append(row)

        waves = [read_one(o, ks) for o, ks in sorted(by_owner.items())]
        rpcs = len(waves)
        await asyncio.gather(*waves)
        agree = all(
            len({int(v) for v in vals}) <= 1 for vals in answered.values()
        )
        if wave_span is not None:
            wave_span.finish(
                owners=rpcs,
                acks_min=int(acks.min()) if b else 0,
                quorum_ok=bool((acks >= self.quorum).all()) if b else True,
            )
        return {
            "keys": int(b),
            "r": self.r,
            "quorum": self.quorum,
            "rpcs": rpcs,
            "acks_min": int(acks.min()) if b else 0,
            "acks_mean": round(float(acks.mean()), 3) if b else 0.0,
            "quorum_ok_frac": round(float((acks >= self.quorum).mean()), 4)
            if b else 1.0,
            "full_ack_frac": round(float((acks >= min(self.r, n_servers)).mean()), 4)
            if b else 1.0,
            "answers_agree": bool(agree),
        }


def quorum_chaos_run(
    *,
    n_servers: int = 8,
    replica_points: int = 16,
    r: int = 3,
    keys_per_tick: int = 64,
    horizon: int = 32,
    journal_every: int = 2,
    seed: int = 0,
    plan=None,
    network=None,
) -> dict:
    """Score quorum reads under a FaultPlan that kills owners mid-read.

    Spins S in-process serve nodes on a ``LocalNetwork`` (each answering
    its reads from the shared committed ring), drives one read wave per
    tick while the plan's timeline black-holes crashed servers (and
    un-black-holes restarts), journals one ``kind:"block"`` record per
    ``journal_every`` ticks with ``detect_frac`` = the FULL-ack fraction
    (so ``chaos.score_blocks``'s time-to-detect reads as ticks-to-full-
    replication-recovery after each crash) plus the quorum fields, and
    reduces the journal through the r10 scorer.  The acceptance bar —
    reads still acking at ⌈(R+1)/2⌉ while the primary is dead — is the
    returned ``quorum_held``."""
    from ringpop_tpu_torch.net.channel import LocalChannel, LocalNetwork
    from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens
    from ringpop_tpu_torch.sim import chaos

    rng = np.random.default_rng(seed)
    servers = [f"10.17.0.{i}:3000" for i in range(n_servers)]
    toks, owns = build_ring_tokens(servers, replica_points, device="cpu")
    tokens32 = toks.numpy().astype(np.uint32)
    owners32 = owns.numpy().astype(np.int32)

    if plan is None:
        # two staggered NON-overlapping owner kills with restarts: at most
        # one of any key's R=3 distinct replicas is dead at a time, so the
        # quorum bar (2 acks) must hold throughout while the FULL-ack
        # fraction dips per crash and recovers at the restart — exactly
        # the recovery curve score_blocks prices
        down = max(4, horizon // 8)
        plan = chaos.churn_plan(
            n_servers, n_churn=2, n_permanent=0, first=4,
            stagger=down + 2, waves=2, down_ticks=down, seed=seed,
            device="cpu",
        )

    net = network if network is not None else LocalNetwork(seed=seed)
    chans = []
    for i, addr in enumerate(servers):
        chan = LocalChannel(net, addr, app="serve-quorum")

        def make_handler(sid: int):
            async def handle(body, headers):
                h = decode_array(body["h"], "<u4")
                idx = np.searchsorted(tokens32, h, side="left")
                idx = np.where(idx >= tokens32.shape[0], 0, idx)
                return {"o": encode_array(owners32[idx], "json", "<i4"), "gen": 0}

            return handle

        chan.register("serve", "/lookup", make_handler(i))
        chans.append(chan)
    client = LocalChannel(net, "10.17.0.99:1", app="quorum-client")
    fwd = BatchForwarder(client, max_retries=0, timeout=0.05)
    reader = QuorumReader(fwd, servers, r=r)

    records: list[dict] = []
    waves: list[dict] = []

    async def drive():
        prev_down: set[int] = set()
        acc = []
        for tick in range(horizon):
            up = chaos.up_at_host(plan, tick, n_servers)
            down = set(np.flatnonzero(~up).tolist())
            for s in down - prev_down:
                net.black_hole(servers[s])
            for s in prev_down - down:
                net.unblack_hole(servers[s])
            prev_down = down
            hashes = rng.integers(0, 2**32, size=keys_per_tick, dtype=np.uint32)
            wave = await reader.quorum_wave(
                tokens32, owners32, n_servers, hashes
            )
            wave["tick"] = tick
            wave["down"] = sorted(down)
            waves.append(wave)
            acc.append(wave)
            if (tick + 1) % journal_every == 0:
                records.append(
                    {
                        "kind": "block",
                        "tick": tick,
                        "ticks": journal_every,
                        # full replication restored == the scorer's
                        # "detection complete" level
                        "detect_frac": min(w["full_ack_frac"] for w in acc),
                        "quorum_ok_frac": min(w["quorum_ok_frac"] for w in acc),
                        "quorum_acks_min": min(w["acks_min"] for w in acc),
                        "rpcs": sum(w["rpcs"] for w in acc),
                        "keys": sum(w["keys"] for w in acc),
                    }
                )
                acc = []

    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(drive())
    finally:
        loop.close()
    score = chaos.score_blocks(records, plan, n=n_servers, scenario="quorum_read")
    killed_any = any(w["down"] for w in waves)
    quorum_held = all(w["quorum_ok_frac"] >= 1.0 for w in waves)
    agree = all(w["answers_agree"] for w in waves)
    total_rpcs = sum(w["rpcs"] for w in waves)
    total_keys = sum(w["keys"] for w in waves)
    return {
        "r": r,
        "quorum": quorum_size(r),
        "n_servers": n_servers,
        "horizon": horizon,
        "keys_per_tick": keys_per_tick,
        "owners_killed": killed_any,
        "quorum_held": quorum_held,
        "answers_agree": agree,
        "rpcs": total_rpcs,
        "keys_read": total_keys,
        # the O(owners) pricing: naive per-(key, replica) RPCs vs coalesced
        "rpcs_naive": total_keys * r,
        "rpc_ratio": round(total_rpcs / max(total_keys * r, 1), 5),
        "score": score,
        "waves": waves,
        "blocks": records,
    }
