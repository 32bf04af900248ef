"""Process-spanning delta engine: the same tick at any process count.

Counterpart of ``ringpop_tpu/sim/delta_multihost.py``, bit for bit.  The
delta step's data motion is two cyclic row-window exchange legs plus two
[W]-word row reduces a tick.  Each process owns the contiguous node block
``partition.process_block`` assigns it, steps it with block-local tensor
code on its device (kernels A–D below), and bridges exactly the exchange
legs and the reduce words over ``parallel.fabric`` — TCP between OS
processes, staged through host memory (device → host → TCP → host →
device, one piece at a time).

Bit-identity with the single-host ``delta.step`` is by construction:

* every random quantity is the partition-invariant counter stream
  (``sim/prng``): value = f(seed, tick, site, GLOBAL lane) — identical on
  any rank layout, zero communication;
* the exchange legs move the same rows the unsharded roll moves;
* the row reduces are bitwise OR/AND — reassociation-exact, so
  block-partial-then-combine equals the single-host tree;
* state digests combine from per-rank partial sums at GLOBAL flat indices
  (``partition.leaf_partial_sums``), so a multi-process digest IS the
  single-host ``telemetry.tree_digest`` value.

On the card, kernel C's two masked row reduces are the S1 kernel of
``csrc/packbits.cu``, ``coverage``'s popcount is S2, and ``state_digest``'s
partial sums are D1 (``csrc/telemetry.cu``); on a CPU tensor each takes its
plain version.

The wire carries what the JAX package's engine sends: packed planes and the
[2, W] reduce words as uint32 (the port's int32 words viewed as uint32), so
``Fabric.wire_stats`` and ``d2h_bytes`` equal the JAX engine's at the same
process count.  Every piece handed to the fabric is a fresh host copy that
the engine never writes, so an overlapped send cannot see a later tick.

Scope: ``exchange="shift"`` + ``rng="counter"``, faults ``None`` or
``up``/scalar ``drop_rate``.  Anything else raises NotImplementedError, as
in the JAX package.
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.parallel.fabric import (
    Fabric,
    encode_array,
    encode_rows,
    plan_window,
    plan_window_swing,
    rows_wire_size,
)
from ringpop_tpu_torch.parallel.partition import (
    combine_leaf_partials,
    leaf_partial_sums,
    process_block,
)
from ringpop_tpu_torch.sim import prng
from ringpop_tpu_torch.sim.delta import (
    DeltaFaults,
    DeltaParams,
    DeltaState,
    clamped_max_p,
    state_from_numpy,
)
from ringpop_tpu_torch.sim.packbits import (
    and_reduce_rows,
    block_count,
    n_words,
    nonzero_rows,
    or_reduce_rows,
    pack_bool,
    popcount_rows,
    row_mask,
    unpack_bits,
)

# low-byte leg ids; the wire tag is ``tick << 8 | leg`` (mod 2^32, see
# _tag) so a message from a diverged rank schedule fails the fabric's
# tag check loudly instead of being consumed as a later tick's payload
_TAG_LEG1 = 0x10
_TAG_LEG2 = 0x20
_TAG_REDUCE = 0x30
_TAG_DIGEST = 0x40
_TAG_COVER = 0x50


def _tag(tick: int, leg: int) -> int:
    return ((tick << 8) | leg) & 0xFFFFFFFF


def _check_supported(params: DeltaParams, faults) -> None:
    if params.exchange != "shift" or params.rng != "counter":
        raise NotImplementedError(
            "multihost delta bridge supports the sharded-caller defaults "
            "only (exchange='shift', rng='counter')"
        )
    if faults is not None and (
        getattr(faults, "group", None) is not None
        or getattr(faults, "drop_node", None) is not None
        or getattr(faults, "reach", None) is not None
        or getattr(faults, "tier_ids", None) is not None
        or getattr(faults, "tier_drop", None) is not None
        or getattr(faults, "suspect_ticks", None) is not None
        or hasattr(faults, "at_tick")
    ):
        raise NotImplementedError(
            "multihost delta bridge supports faults=None or up/drop_rate "
            "legs; group/reach/drop_node/topology-tier/suspect_ticks/"
            "FaultPlan run on the mesh path"
        )


def _host_u32(t: torch.Tensor) -> np.ndarray:
    """A host copy of int32 words as the uint32 words the wire carries: a
    fresh buffer (``copy=True`` also on the CPU, where ``.cpu()`` would
    share the plane's storage) that nothing writes afterwards."""
    return t.detach().to("cpu", copy=True).numpy().view(np.uint32)


# -- block-local kernels ------------------------------------------------------
# Every rank runs the same program on its rows [lo, lo + block); ``lo`` and
# the tick are host ints.


def _k_init(params: DeltaParams, lo: int, block: int, seed: int, dev: torch.device):
    """Rows [lo, lo+block) of ``delta.init_state`` — elementwise equality
    against the source row (rumor j seeds at node j mod n)."""
    n, k = params.n, params.k
    g = lo + torch.arange(block, dtype=torch.int64, device=dev)
    src = torch.arange(k, dtype=torch.int64, device=dev) % n
    learned_b = g[:, None] == src[None, :]
    pcount = torch.zeros((block, k), dtype=torch.int8, device=dev)
    return (
        pack_bool(learned_b),
        pcount,
        pack_bool(pcount < clamped_max_p(params)),
        prng.prng_key(seed, dev),
    )


def _conn_rows(params, cseed, ctick, g, s, up, has_up: bool, has_drop: bool, drop_rate):
    """Connectivity verdict for the (g -> g+s) legs of GLOBAL rows ``g`` —
    pure in (seed, tick, lane), so any rank can evaluate any row's verdict
    without communication (the receiver recomputes the sender's coin).
    The loss coin is compared in float32 (``u >= drop_rate``)."""
    n = params.n
    conn = torch.ones(g.shape, dtype=torch.bool, device=g.device)
    if has_up:
        conn &= up[g] & up[(g + s) % n]
    if has_drop:
        u = prng.draw_uniform(cseed, ctick, prng.D_DROP, g)
        conn &= u >= drop_rate
    return conn


def _k_sent(params, learned_l, ride_ok_l, key, tick, lo, up, drop_rate, has_up, has_drop):
    """Kernel A: the request-leg plane this block contributes."""
    b = learned_l.shape[0]
    cseed = prng.fold_key(key)
    s = prng.draw_randint(cseed, tick, prng.D_SHIFT, 0, 1, params.n)
    g = lo + torch.arange(b, dtype=torch.int64, device=learned_l.device)
    conn = _conn_rows(params, cseed, tick, g, s, up, has_up, has_drop, drop_rate)
    riding = learned_l & ride_ok_l
    sent = riding & row_mask(conn)
    return sent, conn, riding, s


def _k_merge(params, learned_l, ride_ok_l, inbound_l, key, tick, lo, s, up, drop_rate, has_up, has_drop):
    """Kernel B: merge the request leg; derive the response-leg plane.
    ``got_pinged`` is recomputed locally from the lane-pure connectivity
    verdict of the SENDER rows (g - s) — no second window transfer."""
    b = learned_l.shape[0]
    cseed = prng.fold_key(key)
    g = lo + torch.arange(b, dtype=torch.int64, device=learned_l.device)
    src = (g - s) % params.n
    got_pinged = _conn_rows(params, cseed, tick, src, s, up, has_up, has_drop, drop_rate)
    learned1 = learned_l | inbound_l
    answerable = learned1 & ride_ok_l
    return learned1, answerable, got_pinged


def _k_counters(params, learned_l, learned1_l, resp_src_l, conn_l, got_pinged_l, riding_l, pcount_l, up_l, has_up):
    """Kernel C: response merge + piggyback counters + this block's
    partial words of the two global row reduces (S1 on the card, reading
    the up mask directly: dead rows count as all-ones to the AND and as
    zero to the OR, as the JAX package's masked copies do)."""
    k = params.k
    max_p = clamped_max_p(params)
    resp = resp_src_l & row_mask(conn_l)
    learned2 = learned1_l | resp
    riding_bit = unpack_bits(riding_l, k)
    bump = riding_bit.to(torch.int8) * (conn_l.to(torch.int8) + got_pinged_l.to(torch.int8))[:, None]
    newly = unpack_bits(learned2 & ~learned_l, k)
    pcount_mid = (pcount_l + bump).clamp_max(max_p).masked_fill(newly, 0)
    mid_ride = pack_bool(pcount_mid < max_p)
    rows = up_l if has_up else None
    part_and = and_reduce_rows(learned2, rows)
    part_or = or_reduce_rows(learned2 & mid_ride, rows)
    return learned2, pcount_mid, mid_ride, part_and, part_or


def _k_finish(params, learned2_l, pcount_mid_l, mid_ride_l, fully_w, riding_any_w):
    """Kernel D: apply the full-sync stuck-rumor reset with the GLOBAL
    reduce words; report convergence (free — ``fully`` is the converged
    plane's AND)."""
    k = params.k
    fully = unpack_bits(fully_w, k)
    stuck = ~unpack_bits(riding_any_w, k) & ~fully
    reset = learned2_l & pack_bool(stuck)[None, :]
    pcount = pcount_mid_l.masked_fill(unpack_bits(reset, k), 0)
    ride_ok = mid_ride_l | reset
    return pcount, ride_ok, fully.all()


def _k_coverage_bits(learned_l, g: int):
    """Exact learned-bit count of a block as ``g`` chunk sums (S2's per-row
    popcounts, each chunk of block/g rows summed; the host folds them in
    int64)."""
    per_row = popcount_rows(learned_l)
    return per_row.reshape(g, -1).sum(dim=1, dtype=torch.int64)


# -- device-side window programs ----------------------------------------------


def _k_window_all(plane, start: int):
    """The P=1 degenerate window: the whole plane cyclically shifted by
    ``start`` — a device gather, so the single-process exchange leg moves
    zero bytes to the host."""
    n = plane.shape[0]
    idx = (start + torch.arange(n, dtype=torch.int64, device=plane.device)) % n
    return plane.index_select(0, idx)


def _k_plane_nzbits(plane):
    """Send-side nonzero-row summary of one exchange plane: the nonzero-row
    bitmap packed LSB-first — byte for byte the fabric's ROWS wire bitmap
    (``pack_bool``'s little-endian word view == ``np.packbits(bitorder=
    "little")``)."""
    return pack_bool(nonzero_rows(plane))


def _k_rows_gather(plane, idx):
    """The nonzero rows a ROWS-encoded piece ships: a device gather over
    the host-built index, exactly ``nnz`` rows."""
    return plane.index_select(0, idx)


class MultihostDelta:
    """One rank's block of a delta run over the host-bridged DCN fabric.

    The same class runs single-process (``nprocs=1``, fabric legs become
    local gathers) — that degenerate instance is ``delta.step`` by
    construction, and the 2/4-process instances equal IT digest for
    digest.

    ``schedule`` — ``"cyclic"`` (direct window sends) or ``"swing"``
    (distance-halving relay rounds, power-of-two P; ``plan_window_swing``);
    ``overlap`` — each round's sends drain on the fabric's sender threads
    while the engine computes on, joined only where inbound rows are
    consumed.  Both are bit-transparent.  ``device`` holds the block (the
    card unless the caller asks for the CPU).  State and faults cross from
    the JAX package as numpy: ``delta.faults_from_numpy`` for the faults,
    :meth:`_install_block_state` for a rank's block of a state.
    """

    def __init__(
        self,
        params: DeltaParams,
        fabric: Fabric,
        seed: int = 0,
        faults: Optional[DeltaFaults] = None,
        schedule: str = "cyclic",
        overlap: bool = False,
        device: DeviceLike = None,
    ):
        _check_supported(params, faults)
        if schedule not in ("cyclic", "swing"):
            raise ValueError(f"unknown exchange schedule {schedule!r}")
        if schedule == "swing" and fabric.nprocs > 1 and (
            fabric.nprocs & (fabric.nprocs - 1)
        ):
            raise ValueError(
                "swing schedule requires a power-of-two process count, got "
                f"{fabric.nprocs} (select schedule='cyclic')"
            )
        self.device = resolve_device(device)
        dev = self.device
        self.schedule, self.overlap = schedule, bool(overlap)
        self.params, self.fabric = params, fabric
        self.rank, self.nprocs = fabric.rank, fabric.nprocs
        self.lo, self.hi = process_block(params.n, self.rank, self.nprocs)
        self.block = self.hi - self.lo
        self.has_up = faults is not None and faults.up is not None
        self.has_drop = faults is not None and faults.drop_rate is not None
        # ``up`` is replicated per process (1 byte a node); the big O(N*K)
        # planes are what sharding is for
        self.up = (
            torch.as_tensor(faults.up).to(device=dev, dtype=torch.bool)
            if self.has_up else torch.zeros((1,), dtype=torch.bool, device=dev)
        )
        self.up_l = self.up[self.lo : self.hi] if self.has_up else self.up
        self.drop_rate = torch.as_tensor(
            faults.drop_rate if self.has_drop else 0.0, dtype=torch.float32
        ).to(dev)
        self.learned, self.pcount, self.ride_ok, self.key = _k_init(
            params, self.lo, self.block, seed, dev
        )
        self.tick = 0
        self.converged = None  # unknown until a tick reports the AND plane
        # device→host transfer of the exchange legs: summaries + pieces
        self.d2h_bytes = 0
        # journal per-interval deltas: counters at the last journal_record
        self._journal_prev = {"tick": 0, "wire": 0, "raw": 0,
                              "leg": {"leg1": 0.0, "leg2": 0.0, "reduce": 0.0},
                              "hidden": 0.0}
        # per-leg blocked wall, and the send-drain wall that ran hidden
        # under compute (folded lazily from drained handles)
        self._leg_wait_s = {"leg1": 0.0, "leg2": 0.0, "reduce": 0.0}
        self._hidden_s = 0.0
        self._inflight: list = []
        # a fresh engine breaks any XOR-delta payload history a reused
        # fabric carries (and restore may change P) — every rank constructs
        # its engine at the same protocol point
        self.fabric.reset_codec_state()
        # coverage chunking: block/g rows a chunk, each chunk's bit count
        # under 2^26
        g = 1
        while (self.block // g) * params.k > (1 << 26) and g < self.block:
            g *= 2
        self._cover_g = block_count(self.block, g)

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        """Received uint32 words as the device's int32 words."""
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:
            arr = arr.copy()
        return torch.from_numpy(arr.view(np.int32)).to(self.device)

    # -- the exchange legs ----------------------------------------------------

    def _plane_summary(self, plane_dev):
        """Send-side nonzero-row summary of one exchange plane (codec
        path): the packed device bitmap unpacked to a host mask + prefix
        sums, shared by every piece decision of the leg."""
        b = self.block
        bits_host = _host_u32(_k_plane_nzbits(plane_dev))
        self.d2h_bytes += bits_host.nbytes
        mask_all = np.unpackbits(
            bits_host.view(np.uint8), count=b, bitorder="little"
        ).astype(bool)
        cum = np.zeros(b + 1, np.int64)
        np.cumsum(mask_all, out=cum[1:])
        return mask_all, cum

    def _piece_item(self, plane_dev, s0: int, glen: int, summ):
        """One contiguous LOCAL piece ``[s0, s0+glen)`` of the plane as a
        fabric wire item: ROWS pre-encoded when the nonzero-row summary
        says it pays (transfer = nonzero rows only), else the dense slice
        (pre-encoded ``rows=False`` so the fabric does not re-scan what the
        summary already rejected).  ``summ`` is the ``_plane_summary``
        pair, or None when the codec is off."""
        tail = tuple(plane_dev.shape[1:])
        row_nbytes = int(np.prod(tail, dtype=np.int64)) * 4
        if summ is not None:
            mask_all, cum = summ
            nnz = int(cum[s0 + glen] - cum[s0])
            if rows_wire_size(glen, nnz, row_nbytes) < glen * row_nbytes:
                if nnz:
                    idx = np.flatnonzero(mask_all[s0 : s0 + glen]) + s0
                    payload = _host_u32(_k_rows_gather(
                        plane_dev, torch.from_numpy(idx).to(plane_dev.device)))
                else:
                    payload = np.empty((0,) + tail, np.uint32)
                self.d2h_bytes += payload.nbytes
                return encode_rows(mask_all[s0 : s0 + glen], payload, (glen,) + tail, np.uint32)
        raw = _host_u32(plane_dev[s0 : s0 + glen])
        self.d2h_bytes += raw.nbytes
        return encode_array(raw, rows=False) if summ is not None else raw

    def _wait(self, handles, leg: str):
        """Join a round's completions, attributing the blocked wall to
        ``leg``.  ``handles`` is (recv_handle, send_handle): the receive
        expectations are posted first (the demux threads decode inbound
        while this rank still encodes its own pieces) and the sends second.
        Sync mode joins the sends too; overlap mode leaves them draining
        and stamps the resume point for the hidden-drain fold."""
        recv_h, send_h = handles
        t0 = time.perf_counter()
        got = recv_h.wait(join_sends=not self.overlap)
        if send_h is not None:
            send_h.wait(join_sends=not self.overlap)
        self._leg_wait_s[leg] += time.perf_counter() - t0
        resume = time.monotonic()
        for h in (recv_h, send_h):
            if h is not None:
                h.resumed_s = resume
                self._inflight.append(h)
        return got

    def _note_reduce_round(self, handle) -> None:
        """Track a reduce-allgather round: its blocked wall (the handle's
        own ``waited_s``) and the handle for the hidden-drain fold."""
        self._leg_wait_s["reduce"] += handle.waited_s
        handle.resumed_s = time.monotonic()
        self._inflight.append(handle)

    def _fold_round_timings(self) -> None:
        """Price drained rounds into ``overlap_hidden_ms``: the send-drain
        wall that completed AFTER the engine resumed computing.  Sync mode
        joins every send before resuming, so its share is zero by
        construction; rounds still draining stay queued."""
        keep = []
        for h in self._inflight:
            done = h.sends_done_s()
            if done is None:
                keep.append(h)
                continue
            self._hidden_s += max(0.0, done - getattr(h, "resumed_s", h.issued_s))
        self._inflight = keep

    def _exchange_window(self, plane_dev, rel_shift: int, tag: int, leg: str):
        """All ranks exchange so each assembles its own window
        ``[lo + rel_shift, lo + rel_shift + B) mod n`` of the node-sharded
        ``plane`` (leg 1: -s; leg 2: +s — the same on every rank).  At P=1
        the window is a device gather; at P>1 the per-peer pieces leave the
        device as slices, or as their nonzero rows only under the codec, and
        the received pieces are uploaded and stitched by one concatenate."""
        n, b = self.params.n, self.block
        if self.nprocs == 1:
            return _k_window_all(plane_dev, (self.lo + rel_shift) % n)
        if self.schedule == "swing":
            return self._exchange_window_swing(plane_dev, rel_shift, tag, leg)
        my_plan = plan_window((self.lo + rel_shift) % n, b, n, self.nprocs)
        recv_from = sorted({owner for owner, *_ in my_plan if owner != self.rank})
        recv_h = self.fabric.exchange_async(tag, {}, recv_from)
        summ = self._plane_summary(plane_dev) if self.fabric.codec else None
        # for every other rank, the pieces of MY rows its window needs, in
        # ITS window order (one wire array a piece)
        sends: dict[int, list] = {}
        for r in range(self.nprocs):
            if r == self.rank:
                continue
            r_lo = process_block(n, r, self.nprocs)[0]
            plan = plan_window((r_lo + rel_shift) % n, b, n, self.nprocs)
            items = [
                self._piece_item(plane_dev, glo - self.lo, glen, summ)
                for owner, glo, glen, _ in plan
                if owner == self.rank
            ]
            if items:
                sends[r] = items
        send_h = self.fabric.exchange_async(tag, sends, []) if sends else None
        got = self._wait((recv_h, send_h), leg)
        used: dict[int, int] = {r: 0 for r in recv_from}
        parts = []
        for owner, glo, glen, woff in my_plan:
            if owner == self.rank:
                parts.append(plane_dev[glo - self.lo : glo - self.lo + glen])
            else:
                parts.append(self._to_dev(got[owner][used[owner]]))
                used[owner] += 1
        return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]

    def _exchange_window_swing(self, plane_dev, rel_shift: int, tag: int, leg: str):
        """The distance-halving execution of the same window assembly:
        ``log2(P)`` rounds against one partner each (``plan_window_swing``
        manifests, wire tag ``tag + j``); a piece's first hop leaves the
        device, relay hops forward the received host rows, and the fabric
        prices every forwarded copy."""
        n, b, P = self.params.n, self.block, self.nprocs
        rounds = plan_window_swing(rel_shift % n, n, P)
        summ = self._plane_summary(plane_dev) if self.fabric.codec else None
        store: dict[tuple, np.ndarray] = {}
        for j, manifest in enumerate(rounds):
            q = self.rank ^ (1 << j)
            out_entries = manifest.get(self.rank, ())
            in_entries = manifest.get(q, ())
            recv_h = self.fabric.exchange_async(
                tag + j, {}, [q] if in_entries else []
            )
            items = []
            for entry in out_entries:
                d, owner, glo, glen, woff = entry
                if owner == self.rank:
                    items.append(self._piece_item(plane_dev, glo - self.lo, glen, summ))
                else:
                    items.append(store.pop(entry))
            send_h = (
                self.fabric.exchange_async(tag + j, {q: items}, [])
                if items else None
            )
            got = self._wait((recv_h, send_h), leg)
            for entry, arr in zip(in_entries, got.get(q, [])):
                store[entry] = arr
        my_plan = plan_window((self.lo + rel_shift) % n, b, n, P)
        parts = []
        for owner, glo, glen, woff in my_plan:
            if owner == self.rank:
                parts.append(plane_dev[glo - self.lo : glo - self.lo + glen])
            else:
                parts.append(self._to_dev(store.pop((self.rank, owner, glo, glen, woff))))
        assert not store, f"undelivered swing pieces: {sorted(store)}"
        return torch.cat(parts, dim=0) if len(parts) > 1 else parts[0]

    # -- one protocol period --------------------------------------------------

    def step(self) -> None:
        """One tick.  Two host syncs: the tick's shift (``int``) and the
        convergence flag (``bool``)."""
        p = self.params
        self._fold_round_timings()
        sent, conn, riding, s_dev = _k_sent(
            p, self.learned, self.ride_ok, self.key, self.tick, self.lo, self.up,
            self.drop_rate, self.has_up, self.has_drop,
        )
        s = int(s_dev)
        inbound = self._exchange_window(sent, -s, _tag(self.tick, _TAG_LEG1), "leg1")
        learned1, answerable, got_pinged = _k_merge(
            p, self.learned, self.ride_ok, inbound, self.key, self.tick, self.lo, s,
            self.up, self.drop_rate, self.has_up, self.has_drop,
        )
        resp_src = self._exchange_window(
            answerable, +s, _tag(self.tick, _TAG_LEG2), "leg2"
        )
        learned2, pcount_mid, mid_ride, part_and, part_or = _k_counters(
            p, self.learned, learned1, resp_src, conn, got_pinged, riding,
            self.pcount, self.up_l, self.has_up,
        )
        if self.nprocs > 1:
            # stream="reduce": the [2, W] words recur shape-stable every
            # tick — the XOR-delta codec's one matching stream; under swing
            # the gather is recursive doubling, under overlap the final
            # round's drain runs behind kernel D
            partials = self.fabric.allgather(
                _tag(self.tick, _TAG_REDUCE),
                _host_u32(torch.stack([part_and, part_or])),
                stream="reduce",
                schedule=self.schedule,
                join_sends=not self.overlap,
                on_round=self._note_reduce_round,
            )
            fully_w = self._to_dev(functools.reduce(np.bitwise_and, [pp[0] for pp in partials]))
            riding_any_w = self._to_dev(functools.reduce(np.bitwise_or, [pp[1] for pp in partials]))
        else:
            fully_w, riding_any_w = part_and, part_or
        self.pcount, self.ride_ok, conv = _k_finish(
            p, learned2, pcount_mid, mid_ride, fully_w, riding_any_w
        )
        self.learned = learned2
        self.converged = bool(conv)
        self.tick += 1

    # -- certification surface ------------------------------------------------

    def _as_block_state(self) -> DeltaState:
        return DeltaState(
            learned=self.learned,
            pcount=self.pcount,
            ride_ok=self.ride_ok,
            tick=torch.tensor(self.tick, dtype=torch.int32, device=self.device),
            key=self.key,
        )

    def state_digest(self) -> int:
        """The GLOBAL ``telemetry.tree_digest`` of the full DeltaState —
        per-rank partial leaf sums (D1 on the card) at global flat indices,
        one uint32[L] allgather, host combine.  Equal to the single-host
        digest of the same trajectory bit for bit."""
        part = leaf_partial_sums(
            self._as_block_state(), lo=self.lo, include_replicated=self.rank == 0
        ).cpu().numpy().astype(np.uint32)
        parts = (
            self.fabric.allgather(_tag(self.tick, _TAG_DIGEST), part)
            if self.nprocs > 1
            else [part]
        )
        return combine_leaf_partials(parts)

    def coverage(self) -> float:
        """Exact global learned-bit fraction over ALL rows (chunk partials
        summed in int64 on the host — deterministic at any process count;
        ``delta.converged_fraction`` divides by LIVE rows instead)."""
        mine = int(_k_coverage_bits(self.learned, self._cover_g).sum())
        counts = (
            [
                int(c[0])
                for c in self.fabric.allgather(
                    _tag(self.tick, _TAG_COVER), np.asarray([mine], np.int64)
                )
            ]
            if self.nprocs > 1
            else [mine]
        )
        return float(sum(counts)) / float(self.params.n * self.params.k)

    def leg_timing(self) -> dict:
        """Cumulative per-leg blocked wall + hidden drain, in ms."""
        self._fold_round_timings()
        return {
            "fabric_leg_ms": {
                k: round(v * 1e3, 3) for k, v in self._leg_wait_s.items()
            },
            "overlap_hidden_ms": round(self._hidden_s * 1e3, 3),
        }

    def journal_record(self, light: bool = False) -> dict:
        """One journal block: cumulative fabric counters plus the
        per-interval deltas since the previous record, the codec ratio, the
        schedule, per-leg blocked wall and the hidden drain.  ``light=True``
        skips the state digest (coverage stays).  Collective either way
        (coverage allgathers): every rank must pass the same ``light``."""
        self._fold_round_timings()
        ws = self.fabric.wire_stats()
        prev = self._journal_prev
        wire_d = ws["bytes_sent"] - prev["wire"]
        raw_d = ws["raw_bytes_sent"] - prev["raw"]
        leg_ms = {
            k: round((self._leg_wait_s[k] - prev["leg"][k]) * 1e3, 3)
            for k in self._leg_wait_s
        }
        hidden_ms = round((self._hidden_s - prev["hidden"]) * 1e3, 3)
        rec = {
            "tick": self.tick,
            "coverage": round(self.coverage(), 6),
            **({} if light else {"digest": self.state_digest()}),
            "process_count": self.nprocs,
            "process_id": self.rank,
            "schedule": self.schedule,
            "overlap": self.overlap,
            "fabric_bytes_sent": ws["bytes_sent"],
            "fabric_bytes_recv": ws["bytes_recv"],
            "fabric_raw_sent": ws["raw_bytes_sent"],
            "fabric_raw_recv": ws["raw_bytes_recv"],
            "fabric_ticks_delta": self.tick - prev["tick"],
            "fabric_wire_sent_delta": wire_d,
            "fabric_raw_sent_delta": raw_d,
            # raw/wire over the interval; 1.0 when nothing crossed (P=1)
            "fabric_codec_ratio": round(raw_d / wire_d, 4) if wire_d else 1.0,
            "fabric_codec_counts": ws["codec_counts"],
            "fabric_leg_ms": leg_ms,
            "overlap_hidden_ms": hidden_ms,
            "d2h_bytes": self.d2h_bytes,
        }
        self._journal_prev = {
            "tick": self.tick, "wire": ws["bytes_sent"],
            "raw": ws["raw_bytes_sent"],
            "leg": dict(self._leg_wait_s), "hidden": self._hidden_s,
        }
        return rec

    # -- block-sharded snapshot / restore -------------------------------------

    def _snapshot_mesh(self):
        """The job's node-axis mesh (rumor axis 1) over gloo, one process a
        rank, so process blocks land where ``partition.process_block`` says;
        None for a single process without a process group (the store is then
        written whole by its one writer)."""
        from ringpop_tpu_torch.parallel import multihost

        if not multihost.distributed_initialized():
            return None
        return multihost.make_multihost_mesh(rumor_shards=1, transport="gloo", device=self.device)

    @staticmethod
    def _check_processes(nprocs: int, what: str) -> None:
        from ringpop_tpu_torch.parallel import multihost

        if nprocs > 1 and multihost.process_count() != nprocs:
            raise RuntimeError(
                f"block-sharded {what} needs the torch.distributed process group up "
                f"at the fabric's process count ({nprocs}); "
                f"multihost.process_count()={multihost.process_count()}"
            )

    def save_snapshot(self, path: str) -> None:
        """Block-sharded checkpoint into the multi-process store at ``path``:
        every process writes only its own rows (``snapshot.save_state_orbax``
        over the job's mesh).  Collective: every rank must call."""
        from ringpop_tpu_torch.sim.snapshot import save_state_orbax

        self._check_processes(self.nprocs, "snapshots")
        save_state_orbax(path, self._as_block_state(), wait=True, mesh=self._snapshot_mesh())
        self.fabric.barrier(f"snapshot-done-{self.tick}")

    @classmethod
    def restore_snapshot(
        cls,
        path: str,
        params: DeltaParams,
        fabric: Fabric,
        faults: Optional[DeltaFaults] = None,
        schedule: str = "cyclic",
        overlap: bool = False,
        device: DeviceLike = None,
    ) -> "MultihostDelta":
        """Restore a block-sharded checkpoint onto THIS fabric's process
        count — which need not match the count that saved it: each process
        reads back exactly its rows from the stored blocks that overlap
        them."""
        from ringpop_tpu_torch.parallel.mesh import delta_shardings
        from ringpop_tpu_torch.sim.snapshot import load_state_orbax

        cls._check_processes(fabric.nprocs, "restore")
        self = cls(params, fabric, seed=0, faults=faults,
                   schedule=schedule, overlap=overlap, device=device)
        n, k = params.n, params.k
        w = n_words(k)

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        example = DeltaState(
            learned=meta((n, w), torch.int32),
            pcount=meta((n, k), torch.int8),
            ride_ok=meta((n, w), torch.int32),
            tick=meta((), torch.int32),
            key=meta((2,), torch.int64),
        )
        mesh = self._snapshot_mesh()
        shardings = delta_shardings(mesh) if mesh is not None else None
        self._install_block_state(load_state_orbax(path, example, shardings=shardings, device=self.device))
        self.fabric.barrier(f"restore-done-{self.tick}")
        return self

    def _install_block_state(self, local) -> None:
        """Adopt a LOCAL block of DeltaState (tick included) — this port's
        tensors, or the JAX package's leaves as numpy — and reset the
        wire-codec streams: any XOR-delta payload history predates the
        restore, and the restoring fabric may run a different process count
        than the saver, so the epoch word bumps on every rank here."""
        if not isinstance(local.learned, torch.Tensor):
            local = state_from_numpy(local, self.device)
        self.learned = local.learned.to(self.device)
        self.pcount = local.pcount.to(self.device)
        self.ride_ok = local.ride_ok.to(self.device)
        self.key = local.key.to(self.device)
        self.tick = int(local.tick)
        self.converged = None
        self.fabric.reset_codec_state()
        # re-base the journal deltas: the restored tick may sit before the
        # last journaled tick, and the restore-era traffic belongs to no
        # interval
        self._fold_round_timings()
        ws = self.fabric.wire_stats()
        self._journal_prev = {
            "tick": self.tick, "wire": ws["bytes_sent"],
            "raw": ws["raw_bytes_sent"],
            "leg": dict(self._leg_wait_s), "hidden": self._hidden_s,
        }

    def run_until_converged(
        self,
        max_ticks: int = 10_000,
        sink=None,
        journal_every: int = 0,
        journal_light: bool = False,
    ):
        """Step until the global AND plane reports convergence (checked
        every tick — the reduce words already cross the fabric).  Returns
        (ticks_used, converged).

        ``journal_every > 0`` builds a journal record every that-many ticks
        plus one at exit.  Record building is collective, so every rank
        must pass the same ``journal_every``; ranks without a ``sink`` take
        part and drop the record.  ``journal_light`` makes the periodic
        records skip the state digest; the exit record is always full."""
        start = self.tick
        emitted_at = None
        while self.tick - start < max_ticks:
            self.step()
            done = bool(self.converged)
            if journal_every and (((self.tick - start) % journal_every == 0) or done):
                rec = self.journal_record(light=journal_light and not done)
                emitted_at = self.tick
                if sink is not None:
                    sink(rec)
            if done:
                break
        if journal_every and emitted_at != self.tick:
            rec = self.journal_record()
            if sink is not None:
                sink(rec)
        return self.tick - start, bool(self.converged)
