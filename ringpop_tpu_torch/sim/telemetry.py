"""Device-resident telemetry plane for the sim engines.

Counterpart of ``ringpop_tpu/sim/telemetry.py``, record for record: cheap
per-tick counters carried on the device through the tick loop and fetched
in blocks, so observability costs no host round trip a tick.

* **Bit-identity.** Telemetry only reads intermediates the protocol tick
  already computes: it consumes no draw and writes nothing back, so a
  telemetry-on run is bit-identical to a telemetry-off one.
* **None costs nothing.** Every seam (``lifecycle.step``, ``_run_block``,
  the ``run_until_*`` drivers) takes ``telemetry=None`` by default, and
  the None leg launches exactly what it launched before telemetry existed.
* **Accumulators shaped like their sources** ([N] per-node masks, [N, W]
  packed planes, [K] slot vectors, [M] placement vectors), reduced to
  scalars once a block in :func:`fetch`.

On the card the tick's [N, W] and [N] legs are one launch of kernel P1, the
state digest one launch of kernel D1 and a record's float32 sums two
launches of kernel R1 (``csrc/telemetry.cu``, ``ops/telemetry_kernel.py``);
on the CPU their plain versions below run.
The accumulators are updated in place (the JAX package's are immutable):
:func:`accumulate` returns the same tensors, one tick further on.

The host half (journal, stats bridge, sink) is the JAX package's, with the
port's own toolchain fingerprint (torch, CUDA, numpy, Python).  Counter
overflow: int32 accumulators hold per-tick increments of at most N (or 32
per packed word); a fetch resets them.  :func:`fetch` reports the N·T-scaling
sums in float32, as the JAX package does, added in the order XLA:CPU adds
them (:func:`f32_sum_plain`), so the two agree bit for bit at every size.

Under a (P, R) mesh (``lifecycle.LifecycleSim(telemetry=..., exchange_mesh=
...)``) the accumulators are shaped like the rank's block: the per-node
counters its rows, the packed planes its rows of its word block, the [K],
[M] and scalar legs whole; :func:`accumulate` is elementwise, so it runs on
the block as it is.  :func:`fetch` gathers the accumulators and the census
vectors whole over both axes and reduces them in the JAX package's order
on every rank, and :func:`tree_digest` gathers a plane's row block over
the rumor axis and combines the node ranks' partial sums.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.ops import telemetry_kernel
from ringpop_tpu_torch.sim.delta import (
    N_TIERS,
    TIER_NAMES,
    DeltaFaults,
    converged_fraction,
    resolve_faults,
    rumor_block,
    sharding_of,
)
from ringpop_tpu_torch.sim.packbits import _POPCOUNT8, M32, mix32
from ringpop_tpu_torch.swim.member import ALIVE, FAULTY, SUSPECT, TOMBSTONE

# record-key suffixes for the per-tier counters ("same_rack", ...)
TIER_KEYS = tuple(name.replace("-", "_") for name in TIER_NAMES)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# elements a chunk of the plain digest takes (its int64 temporaries stay
# at 8 * _DIGEST_CHUNK bytes each, whatever the leaf's size)
_DIGEST_CHUNK = 1 << 24


class TelemetryState(NamedTuple):
    """Per-tick protocol counters, accumulated on the device between
    fetches; every leaf is an elementwise accumulator shaped like the mask
    it counts, and ``fetch`` owns the reduction to scalars."""

    # per-node masks — [N]
    pings: torch.Tensor  # int32[N]: completed direct probe exchanges
    ping_reqs: torch.Tensor  # int32[N]: indirect probe legs issued
    probes_failed: torch.Tensor  # int32[N]: direct probes that found no path
    incarnation_bumps: torch.Tensor  # int32[N]: refutations that placed
    # packed-plane event counts — [N, W], int32 holding uint32
    piggybacked: torch.Tensor  # rumor bits ridden (both legs)
    expired: torch.Tensor  # piggyback gates closed (maxP hit)
    # rumor-table vectors — [K]
    timer_fires: torch.Tensor  # int32[K]: in-flight-rumor state-timer transitions completed
    base_timer_fires: torch.Tensor  # int32[N]: folded-to-base state-timer transitions completed
    # placement vectors — [M], M = alloc budget
    decl_alive: torch.Tensor  # int32[M]: refutation rumors placed
    decl_suspect: torch.Tensor  # int32[M]: suspect declarations placed
    decl_faulty: torch.Tensor  # int32[M]: faulty declarations placed
    decl_tombstone: torch.Tensor  # int32[M]: tombstone (leave) declarations
    # scalars
    heal_attempts: torch.Tensor  # int32[]: partition-healer pair swaps tried
    ticks: torch.Tensor  # int32[]: ticks accumulated since the last fetch
    # optional per-tier suspicion flow (topology plane): None unless armed
    # with ``zeros(params, tiers=True)``
    suspects_by_tier: Optional[torch.Tensor] = None  # int32[N, 4]: declarations by tier
    false_suspects_by_tier: Optional[torch.Tensor] = None  # int32[N, 4]: target was live


def placement_budget(params) -> int:
    """M, the per-tick rumor-allocation budget (the ``m`` of
    ``lifecycle.step``)."""
    return min(params.alloc_per_tick, params.k, params.n)


def zeros(params, tiers: bool = False, device: DeviceLike = None) -> TelemetryState:
    """A zeroed accumulator for a ``LifecycleParams`` config on ``device``
    (the card unless the caller asks for the CPU).  ``tiers`` arms the
    per-tier suspicion counters (topology runs).  Under the params' mesh
    (``delta.sharding_of``), this rank's block: its rows of the per-node
    counters and its rows and words of the planes."""
    dev = resolve_device(device)
    mesh = sharding_of(params)
    n, k = params.n, params.k
    m = placement_budget(params)
    _, words = rumor_block(mesh, k)
    if mesh is not None:
        n = n // mesh.shape["node"]
    i32 = dict(dtype=torch.int32, device=dev)
    tier_kw = (
        {"suspects_by_tier": torch.zeros((n, N_TIERS), **i32),
         "false_suspects_by_tier": torch.zeros((n, N_TIERS), **i32)}
        if tiers else {}
    )
    return TelemetryState(
        **tier_kw,
        pings=torch.zeros((n,), **i32),
        ping_reqs=torch.zeros((n,), **i32),
        probes_failed=torch.zeros((n,), **i32),
        incarnation_bumps=torch.zeros((n,), **i32),
        piggybacked=torch.zeros((n, words.stop - words.start), **i32),
        expired=torch.zeros((n, words.stop - words.start), **i32),
        timer_fires=torch.zeros((k,), **i32),
        base_timer_fires=torch.zeros((n,), **i32),
        decl_alive=torch.zeros((m,), **i32),
        decl_suspect=torch.zeros((m,), **i32),
        decl_faulty=torch.zeros((m,), **i32),
        decl_tombstone=torch.zeros((m,), **i32),
        heal_attempts=torch.zeros((), **i32),
        ticks=torch.zeros((), **i32),
    )


def _popcount_words(p: torch.Tensor) -> torch.Tensor:
    """int32[..., W] -> int32[..., W]: each word's set bits (a byte table)."""
    byts = p.contiguous().view(torch.uint8).to(torch.int64)
    return _POPCOUNT8.to(p.device)[byts].view(*p.shape, 4).sum(dim=-1, dtype=torch.int32)


def accumulate_plain(acc: dict, *, sent_w, resp_w, ride_ok, mid_ride_w, delivered, probing, peer_ok, refute,
                     placed, base_fired) -> None:
    """The plain version of P1 (``ops.telemetry_kernel.accumulate_cuda``):
    the [N, W] and [N] legs of one tick, in place."""
    acc["piggybacked"] += _popcount_words(sent_w) + _popcount_words(resp_w)
    acc["expired"] += _popcount_words(ride_ok & ~mid_ride_w)
    acc["pings"] += delivered
    acc["ping_reqs"] += torch.where(probing, peer_ok.sum(dim=1, dtype=torch.int32), 0)
    acc["probes_failed"] += probing
    acc["incarnation_bumps"] += refute & placed
    acc["base_timer_fires"] += base_fired


def accumulate(
    tel: TelemetryState,
    *,
    delivered: torch.Tensor,  # bool[N]
    probing: torch.Tensor,  # bool[N]
    peer_ok: torch.Tensor,  # bool[N, P]: indirect legs that could be issued
    refute: torch.Tensor,  # bool[N]
    placed: torch.Tensor,  # bool[N]: the node's refutation rumor placed
    sent_w: torch.Tensor,  # int32[N, W]
    resp_w: torch.Tensor,  # int32[N, W]
    ride_ok: torch.Tensor,  # int32[N, W]: the tick-entry gate
    mid_ride_w: torch.Tensor,  # int32[N, W]: the gate after the bump
    fired: torch.Tensor,  # bool[K]
    base_fired: torch.Tensor,  # bool[N]
    place: torch.Tensor,  # bool[M]
    new_status: torch.Tensor,  # int8[M]
    heal_attempt: Optional[torch.Tensor],  # bool[] or None (healer disabled)
    declared: Optional[torch.Tensor] = None,  # bool[N] suspicion declarers (placed)
    declared_tier: Optional[torch.Tensor] = None,  # int32[N] accuser→target tier
    declared_up: Optional[torch.Tensor] = None,  # bool[N] target live per the plan
) -> TelemetryState:
    """One tick's counter updates, in place; returns ``tel``.  The JAX
    package's ``accumulate`` with its derived inputs taken apart, so that
    P1 forms them itself: ``ping_req_legs`` is ``where(probing,
    peer_ok.sum(1), 0)``, ``refuted`` is ``refute & placed`` and
    ``closed_w`` is ``ride_ok & ~mid_ride_w``.  The [N, W] and [N] legs run
    on P1 on the card (one launch); the [K], [M] and scalar legs and the
    tier one-hot are plain PyTorch."""
    acc = {name: getattr(tel, name) for name in (
        "piggybacked", "expired", "pings", "ping_reqs", "probes_failed", "incarnation_bumps", "base_timer_fires")}
    legs = dict(sent_w=sent_w, resp_w=resp_w, ride_ok=ride_ok, mid_ride_w=mid_ride_w, delivered=delivered,
                probing=probing, peer_ok=peer_ok, refute=refute, placed=placed, base_fired=base_fired)
    if tel.piggybacked.device.type == "cpu":
        accumulate_plain(acc, **legs)
    else:
        telemetry_kernel.accumulate_cuda(acc, **legs)
    if tel.suspects_by_tier is not None and declared is not None:
        tiers = torch.arange(N_TIERS, dtype=torch.int32, device=declared.device)
        onehot = declared[:, None] & (declared_tier[:, None] == tiers[None, :])
        tel.suspects_by_tier.add_(onehot)
        tel.false_suspects_by_tier.add_(onehot & declared_up[:, None])
    tel.timer_fires.add_(fired)
    for name, status in (("decl_alive", ALIVE), ("decl_suspect", SUSPECT), ("decl_faulty", FAULTY),
                         ("decl_tombstone", TOMBSTONE)):
        getattr(tel, name).add_(place & (new_status == status))
    if heal_attempt is not None:
        tel.heal_attempts.add_(heal_attempt)
    tel.ticks.add_(1)
    return tel


# -- float32 sums in the JAX package's order (kernel R1) ----------------------

# The JAX package's ``fetch`` sums its counters in float32
# (``x.sum(dtype=float32)``) under ``jax.jit`` on the CPU, and above 2**24
# the order of the adds decides the last bits.  XLA:CPU's tree-reduction
# rewrite turns a reduce over a dimension longer than SUM_WINDOW into a
# chain of reduce-windows of SUM_WINDOW (for an [N, W] plane with W <=
# SUM_WINDOW a window is SUM_WINDOW whole rows), each level padded with
# zeros, pad // 2 of them in front, until at most SUM_WINDOW values are
# left; then one plain reduce adds those in order.  Inside a window the
# adds run in row-major order, except where LLVM vectorizes the window's
# loop (its adds are marked reassociable): at a first level with no
# padding in front, of rows 2..SUM_WINDOW_LANES_MAX_WIDTH words wide, the
# leading rows are summed in window_lanes(W, rows) lanes, row r into lane
# r % L, the lanes halved pairwise, and the other rows added after
# (:func:`_first_level`).  Read from the compiled HLO and the optimized
# LLVM IR (jax 0.9.0, x86-64 with 256-bit vectors) and held against live
# ``jnp.sum`` by tests/test_torch_telemetry.py.  One reduce is not pinned: a full sum of an
# [N, W] plane with W >= 2 and N <= SUM_WINDOW (or W > SUM_WINDOW) ends in a
# plain reduce of two or more columns, which LLVM vectorizes with lanes and
# a remainder that its cost model picks by N and W; there the sum is taken
# exactly and rounded once, which is what any order gives while the sum
# stays below 2**24 (ROADMAP Queue C).
SUM_WINDOW = 32
SUM_WINDOW_LANES_MAX_WIDTH = 8


def window_lanes(width: int, rows: int = SUM_WINDOW) -> int:
    """The lanes in which LLVM sums a window's loop over ``rows`` rows
    (SUM_WINDOW, or one less when the level's last window ends in a row of
    padding) of ``width`` words: for 32 rows 8 lanes at 2..6 words and 4 at
    7..8; for 31 rows 8 at 2 words and 4 at 3..8; else 1 (in order)."""
    if width < 2 or width > SUM_WINDOW_LANES_MAX_WIDTH:
        return 1
    return 8 if width <= (6 if rows == SUM_WINDOW else 2) else 4


def _rows_width(x: torch.Tensor) -> tuple[int, int]:
    """(rows, words a row) of a 0-d, [N] or [N, W] tensor."""
    return (x.shape[0] if x.dim() else 1), (x.shape[1] if x.dim() == 2 else 1)


def _as_f32(x: torch.Tensor, unsigned: bool) -> torch.Tensor:
    """Each element as float32, rounded to nearest (uint32 planes held in
    int32 by their unsigned value)."""
    if unsigned:
        x = x.to(torch.int64) & M32
    return x.to(torch.float32)


def _pad_rows(a: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``a`` [R, ...] padded with zero rows to a multiple of SUM_WINDOW,
    pad // 2 in front; returns it and the pad."""
    pad = -a.shape[0] % SUM_WINDOW
    if pad:
        lo = a.new_zeros((pad // 2, *a.shape[1:]))
        hi = a.new_zeros((pad - pad // 2, *a.shape[1:]))
        a = torch.cat([lo, a, hi])
    return a, pad


def _column_levels(a: torch.Tensor) -> torch.Tensor:
    """float32 [R, C] -> [C]: each column summed as XLA sums a vector: windows
    of SUM_WINDOW in order, level by level, then the last at most
    SUM_WINDOW values in order."""
    while a.shape[0] > SUM_WINDOW:
        a, _ = _pad_rows(a)
        win = a.view(-1, SUM_WINDOW, a.shape[1])
        acc = win[:, 0].clone()
        for r in range(1, SUM_WINDOW):
            acc = acc + win[:, r]
        a = acc
    total = a[0].clone()
    for r in range(1, a.shape[0]):
        total = total + a[r]
    return total


def sum_lanes(rows: int, width: int) -> int:
    """How the first level of a full sum of ``rows`` x ``width`` words is
    taken: 0 for the reduce whose order is not pinned (exact, rounded
    once), else its windows' lanes (1: in order)."""
    if width > 1 and (rows <= SUM_WINDOW or width > SUM_WINDOW):
        return 0
    pad = -rows % SUM_WINDOW
    return window_lanes(width, SUM_WINDOW - (pad - pad // 2)) if rows > SUM_WINDOW and pad // 2 == 0 else 1


def _first_level(a: torch.Tensor) -> torch.Tensor:
    """float32 [R, W] (R > SUM_WINDOW, W <= SUM_WINDOW) -> [windows]: the
    first reduce-window of a full sum, SUM_WINDOW whole rows a window.
    With no padding in front (a pad of 0 or 1), XLA's loop over the rows
    in bounds in every window (all SUM_WINDOW, or all but the last) has no
    bounds check, and LLVM sums its first rows in lanes (window_lanes: row
    r into lane r % L, whole lane-counts of rows), halves the lanes, then
    adds the rest of the window's rows in order."""
    a, pad = _pad_rows(a)
    w = a.shape[1]
    win = a.view(-1, SUM_WINDOW, w)
    lanes = sum_lanes(a.shape[0] - pad, w)
    if lanes == 1:
        acc, first = win[:, 0, 0].clone(), 1
    else:
        first = (SUM_WINDOW - pad) // lanes * lanes  # pad is 0 or 1 here
        grid = win[:, :first].reshape(-1, first // lanes, lanes, w)  # row i * lanes + l in lane l
        acc = grid[:, 0, :, 0].clone()
        for i in range(first // lanes):
            for c in range(w):
                if i or c:
                    acc = acc + grid[:, i, :, c]
        while acc.shape[1] > 1:
            half = acc.shape[1] // 2
            acc = acc[:, :half] + acc[:, half:]
        acc, first = acc[:, 0], first * w
    flat = win.reshape(win.shape[0], -1)
    for e in range(first, SUM_WINDOW * w):
        acc = acc + flat[:, e]
    return acc


def f32_sum_plain(x: torch.Tensor, unsigned: bool = False, by_column: bool = False) -> torch.Tensor:
    """The plain version of R1 for one input: ``x.sum(dtype=float32)`` as
    the JAX package takes it, bit for bit (0-d float32); with
    ``by_column``, ``x.sum(axis=0, dtype=float32)`` of an [N, C] tensor
    ([C] float32).  ``x`` is bool, int32, or with ``unsigned`` int32
    holding uint32 bits, of at most two dimensions.  Built from float32
    adds of one window position at a time (torch's own sums do not fix
    their order)."""
    if x.dim() > 2 or (by_column and x.dim() != 2):
        raise ValueError(f"f32_sum takes tensors of at most two dimensions ([N, C] by column), got {list(x.shape)}")
    if by_column:
        if x.shape[0] == 0:
            return torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
        return _column_levels(_as_f32(x, unsigned))
    rows, width = _rows_width(x)
    a = _as_f32(x, unsigned).reshape(rows, width)
    if a.numel() == 0:
        return torch.zeros((), dtype=torch.float32, device=x.device)
    if sum_lanes(rows, width) == 0:
        wide = x.to(torch.int64) & M32 if unsigned else x.to(torch.int64)
        return wide.sum().to(torch.float32)
    if rows > SUM_WINDOW:
        a = _first_level(a)[:, None]
    return _column_levels(a)[0]


def f32_sums(inputs: list) -> torch.Tensor:
    """float32 [outputs]: the JAX package's float32 sums of ``inputs``, a
    list of ``(x, unsigned, by_column)`` on one device, in order (an input
    by column gives one output a column).  Kernel R1 on the card (two
    launches for the whole list), :func:`f32_sum_plain` on the CPU."""
    if inputs and inputs[0][0].device.type != "cpu":
        return telemetry_kernel.f32_sums_cuda([
            (x, u, c, 1 if c else sum_lanes(*_rows_width(x))) for x, u, c in inputs])
    return torch.cat([f32_sum_plain(x, u, c).reshape(-1) for x, u, c in inputs])


# -- fetch: the once-per-block reduction + census ----------------------------


def _census(state, faults: DeltaFaults) -> tuple[dict, list]:
    """Point-in-time membership census from the converged base view, and
    the float32 sums (down, detected) of the detection fraction over the
    fault model's down nodes (none without a fault model)."""
    present = state.base_present
    status = state.base_status

    def count(s):
        return (present & (status == s)).sum(dtype=torch.int32)

    out = {
        "num_members": present.sum(dtype=torch.int32),
        "census_alive": count(ALIVE),
        "census_suspect": count(SUSPECT),
        "census_faulty": count(FAULTY),
        "census_tombstone": count(TOMBSTONE),
        "rumors_active": (state.r_subject >= 0).sum(dtype=torch.int32),
    }
    if faults.up is None:
        return out, []
    down = ~faults.up
    return out, [(down, False, False), (down & (~present | (status >= FAULTY)), False, False)]


# the accumulators that are whole on every rank under a mesh
_WHOLE_LEGS = ("timer_fires", "decl_alive", "decl_suspect", "decl_faulty", "decl_tombstone", "heal_attempts",
               "ticks")


def _whole(tel: TelemetryState, state, mesh):
    """The accumulators and the census' per-node vectors (``base_present``,
    ``base_status``) gathered whole from every rank's block, on the
    device: the planes over both axes, the per-node counters over the node
    axis (``partition.host_gather``); the other leaves as they are."""
    from ringpop_tpu_torch.parallel.partition import host_gather

    dev = tel.pings.device
    blocks = tel._replace(**{name: None for name in _WHOLE_LEGS})
    gathered = host_gather(blocks, mesh)
    whole = {name: None if x is None else torch.as_tensor(x, device=dev)
             for name, x in zip(TelemetryState._fields, gathered)}
    whole.update({name: getattr(tel, name) for name in _WHOLE_LEGS})
    census = host_gather({"base_present": state.base_present, "base_status": state.base_status}, mesh)
    state = state._replace(**{name: torch.as_tensor(x, device=dev) for name, x in census.items()})
    return TelemetryState(**whole), state


def fetch(tel: TelemetryState, state, faults: DeltaFaults = DeltaFaults(), mesh=None) -> tuple[dict, TelemetryState]:
    """Reduce the block's accumulators to a scalar record and reset them.
    Returns ``(record, zeroed_tel)``: a flat dict of 0-d tensors on the
    device (``_to_host`` brings them over in one copy).  The float32 sums
    are the JAX package's, bit for bit (:func:`f32_sums`: one R1 call for
    the record on the card).  A time-varying plan is resolved at the
    state's tick; the directed-partition attribution reads the unresolved
    plan's group/reach, which are time-invariant.  With a ``mesh`` (``tel``
    and ``state`` this rank's blocks; a collective) the inputs are gathered
    whole first (:func:`_whole`), so every rank's record is the unsharded
    one."""
    raw_group = getattr(faults, "group", None)
    raw_reach = getattr(faults, "reach", None)
    faults = resolve_faults(faults, state.tick)
    local = tel
    if mesh is not None and mesh.sharded:
        tel, state = _whole(tel, state, mesh)
    sums = [(tel.pings, False, False), (tel.ping_reqs, False, False), (tel.probes_failed, False, False),
            (tel.incarnation_bumps, False, False), (tel.piggybacked, True, False), (tel.expired, True, False),
            (tel.timer_fires, False, False), (tel.base_timer_fires, False, False)]
    if tel.suspects_by_tier is not None:
        sums += [(tel.suspects_by_tier, False, True), (tel.false_suspects_by_tier, False, True)]
    if raw_group is not None and raw_reach is not None:
        # directed-partition attribution: the block's refutations split by
        # whether the refuting subject's group g sits in the unreachable
        # direction of a one-way window (some group a cannot send to g
        # while g can send to a); a symmetric partition reports zero there
        reach_b = torch.as_tensor(raw_reach, device=tel.pings.device).to(torch.bool)
        one_way = ~reach_b & reach_b.transpose(-1, -2)
        blocked = one_way.any(dim=-2)  # [G]
        g = torch.as_tensor(raw_group, device=tel.pings.device).to(torch.int64)
        flag = (g >= 0) & blocked[g.clamp_min(0)]
        bumps = tel.incarnation_bumps
        sums += [(torch.where(flag, bumps, 0), False, False), (torch.where(~flag, bumps, 0), False, False)]
    census, census_sums = _census(state, faults)
    totals = f32_sums(sums + census_sums)
    record = {
        "ticks": tel.ticks,
        "ping_send": totals[0],
        "ping_req_send": totals[1],
        "ping_timeout": totals[2],
        "refuted": totals[3],
        "rumors_piggybacked": totals[4],
        "rumors_expired": totals[5],
        # the JAX package adds the [K] and [N] float32 sums
        "timer_fired": totals[6] + totals[7],
        "decl_alive": tel.decl_alive.sum(dtype=torch.int32),
        "decl_suspect": tel.decl_suspect.sum(dtype=torch.int32),
        "decl_faulty": tel.decl_faulty.sum(dtype=torch.int32),
        "decl_tombstone": tel.decl_tombstone.sum(dtype=torch.int32),
        "heal_attempts": tel.heal_attempts,
        "tick": state.tick,
    }
    at = 8
    if tel.suspects_by_tier is not None:
        for ti, key in enumerate(TIER_KEYS):
            record[f"suspects_{key}"] = totals[at + ti]
            record[f"false_suspects_{key}"] = totals[at + N_TIERS + ti]
        at += 2 * N_TIERS
    if raw_group is not None and raw_reach is not None:
        record["refuted_unreachable_dir"] = totals[at]
        record["refuted_reachable_dir"] = totals[at + 1]
        at += 2
    record.update(census)
    one = torch.ones((), dtype=torch.float32, device=totals.device)
    if census_sums:
        down_total, detected = totals[at], totals[at + 1]
        # an empty down set reports the vacuous 1.0 (a fully recovered
        # cluster under a time-varying plan), as the up-is-None branch does
        record["detect_frac"] = torch.where(down_total > 0, detected / down_total.clamp_min(1.0), one)
    else:
        record["detect_frac"] = one
    fresh = TelemetryState(*(None if x is None else torch.zeros_like(x) for x in local))
    return record, fresh


def split_batched(record: dict, extra: Optional[dict] = None, id_base: int = 0) -> list[dict]:
    """Split one batched block record (every value ``[B]``-leading) into B
    per-scenario host records, each tagged ``scenario_id`` (offset by
    ``id_base``).  ``extra`` merges additional ``[B]`` columns before the
    split; scalars broadcast to every record."""
    host = {k: _host_value(v) for k, v in {**record, **(extra or {})}.items()}
    b = max((np.asarray(v).shape[0] for v in host.values() if np.ndim(v) >= 1), default=1)
    out = []
    for i in range(b):
        sliced = {k: (np.asarray(v)[i] if np.ndim(v) >= 1 else v) for k, v in host.items()}
        out.append({"scenario_id": id_base + i, **_to_host(sliced)})
    return out


# -- order-sensitive state digest (journal pairing) --------------------------


def _leaf_list(tree) -> list:
    """The leaves of a state in the JAX package's pytree order: NamedTuple and
    tuple fields in order, dict values by sorted key, None skipped."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in _leaf_list(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in _leaf_list(sub)]
    raise TypeError(f"tree_digest takes tensors, tuples, lists and dicts, got {type(tree).__name__}")


def leaf_digest_sum_plain(leaf: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """The plain version of D1's leaf sum: the wrapping uint32 sum of
    ``mix32(value ^ mix32(offset + flat index))`` over the elements, as a
    0-d int64 holding the uint32.  The value is the element as uint32 (a
    bool 0/1, an int8 sign-extended as JAX's ``astype(uint32)`` does, int32
    planes as their bits, the int64 key by its low word); the flat index of
    a contiguous [rows, rowlen] leaf is JAX's ``row * rowlen + col``, mod
    2**32.  Taken in chunks of ``_DIGEST_CHUNK`` elements."""
    flat = leaf.reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=leaf.device)
    for lo in range(0, flat.shape[0], _DIGEST_CHUNK):
        v = flat[lo:lo + _DIGEST_CHUNK].to(torch.int64) & M32
        idx = (torch.arange(lo, lo + v.shape[0], dtype=torch.int64, device=leaf.device) + offset) & M32
        total = (total + (mix32(v ^ mix32(idx))).sum()) & M32
    return total


def leaf_digest_sum(leaf: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """0-d int64 holding uint32: one leaf's inner digest sum, the flat
    index starting at ``offset`` (a block at its global offset gives an
    exact partial of the whole leaf's sum).  D1 on a CUDA tensor."""
    leaf = torch.as_tensor(leaf)
    if leaf.device.type == "cpu":
        return leaf_digest_sum_plain(leaf, offset)
    return telemetry_kernel.state_digest_cuda([leaf], offset=offset, final=False)


def tree_digest_plain(tree) -> torch.Tensor:
    """The plain version of D1's tree digest."""
    leaves = _leaf_list(tree)
    dev = leaves[0].device if leaves else torch.device("cpu")
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    for li, leaf in enumerate(leaves):
        acc = acc + mix32(leaf_digest_sum_plain(leaf) ^ ((li * 0x9E37_79B9) & M32))
    return acc & M32


def tree_digest(tree, mesh=None) -> torch.Tensor:
    """0-d int64 holding uint32, on the state's device: a position-sensitive
    digest of every leaf of an integer/bool state (both engines' states
    qualify): the wrapping sum over leaves ``li`` of ``mix32(leaf sum ^ li *
    0x9E3779B9)``.  Two states digest equal iff every leaf is bit-equal (up
    to hash collision).  One launch of D1 (after a zero fill) on the card.

    With a ``mesh``, ``tree`` is this rank's block (a collective): each
    plane's row block gathered over the rumor axis, then each node rank's
    partial sums over its rows at their global flat indices
    (``partition.leaf_partial_sums``, one D1 launch a leaf on the card),
    gathered over the node axis and combined — the whole state's digest,
    on every rank."""
    if mesh is not None and mesh.sharded:
        return _sharded_tree_digest(tree, mesh)
    leaves = _leaf_list(tree)
    if not leaves or leaves[0].device.type == "cpu":
        return tree_digest_plain(tree)
    return telemetry_kernel.state_digest_cuda(leaves)


def _sharded_tree_digest(tree, mesh) -> torch.Tensor:
    """:func:`tree_digest` of a tree whose node-sharded leaves are this
    rank's rows (and its word block of the planes): partial sums of whole
    rows gathered from the node axis and combined."""
    from ringpop_tpu_torch.parallel.partition import (
        _plane_rumor_axis,
        _tree_map_named,
        combine_leaf_partials,
        leaf_partial_sums,
        named_leaves,
        spec_for,
    )

    if mesh.shape["rumor"] > 1:
        tree = _tree_map_named(
            lambda name, leaf: mesh.gather_cols(leaf) if _plane_rumor_axis(spec_for(name)) is not None else leaf,
            tree)
    block = next(leaf.shape[0] for name, leaf in named_leaves(tree) if spec_for(name)[:1] == ("node",))
    partial = leaf_partial_sums(tree, lo=mesh.rank * block, include_replicated=mesh.rank == 0)
    total = combine_leaf_partials(list(mesh.all_gather(partial)))
    return torch.tensor(total, dtype=torch.int64, device=partial.device)


def delta_record(state, faults: DeltaFaults = DeltaFaults(), mesh=None) -> dict:
    """The delta engine's per-block journal record (0-d tensors): coverage
    fraction and the state digest, its convergence series.  With a
    ``mesh``, ``state`` is this rank's block and both values are the whole
    state's (a collective)."""
    return {
        "tick": state.tick,
        "coverage": converged_fraction(state, faults, mesh),
        "digest": tree_digest(state, mesh),
    }


# -- toolchain / mesh-budget fingerprints ------------------------------------


def toolchain_fingerprint() -> dict:
    """The versions that decide whether two captures are comparable: the
    port's torch and CUDA in place of the JAX package's jax and jaxlib."""
    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "python": ".".join(map(str, sys.version_info[:3])),
    }


def mesh_budget_fingerprint(repo: str = _REPO) -> dict:
    """Identity of the collective-budget baseline a journal names
    (``captures/mesh_profile_small_budget.json``): file name and content
    sha256 prefix.  Missing capture → ``{"budget_capture": None}``."""
    path = os.path.join(repo, "captures", "mesh_profile_small_budget.json")
    if not os.path.exists(path):
        return {"budget_capture": None}
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return {"budget_capture": os.path.basename(path), "sha256": digest}


def _host_value(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


def _to_host(record: dict) -> dict:
    """Every value of a record as a host JSON scalar: the tensors come over
    in one copy per dtype, numpy scalars are coerced, floats are rounded to
    6 places (so the journal, the stats bridge and ``TelemetrySink.records``
    carry the same numbers).  Idempotent on host dicts."""
    tensors = {k: v for k, v in record.items() if isinstance(v, torch.Tensor) and v.dim() == 0}
    fetched = {}
    by_dtype: dict = {}
    for k, v in tensors.items():
        by_dtype.setdefault((v.dtype, v.device), []).append(k)
    for (dtype, _), keys in by_dtype.items():
        values = torch.stack([tensors[k] for k in keys]).cpu().numpy()
        fetched.update(zip(keys, values))
    host = {}
    for k, v in record.items():
        v = fetched[k] if k in fetched else _host_value(v)
        if isinstance(v, (np.generic, np.ndarray)):
            v = v.item() if np.ndim(v) == 0 else np.asarray(v).tolist()
        if isinstance(v, float):
            v = round(v, 6)
        host[k] = v
    return host


# -- JSONL run journal -------------------------------------------------------


class TelemetryJournal:
    """One JSONL stream per run: a ``header`` record (engine, params,
    toolchain and mesh-budget fingerprints), then one ``block`` record per
    fetched tick block (and a ``score`` record per chaos scenario).
    Context manager; safe to hand to several scenarios in append mode."""

    def __init__(self, path: str, *, append: bool = False):
        self.path = path
        self._f = open(path, "a" if append else "w", buffering=1)

    def header(self, engine: str, scenario: str = "", params: Optional[dict] = None) -> None:
        from ringpop_tpu_torch.obs.flight import git_commit
        from ringpop_tpu_torch.util.accel import cache_status

        # which rank of which job size wrote the stream: 1/0 unless a
        # torch.distributed group is up
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            pc, pid = dist.get_world_size(), dist.get_rank()
        else:
            pc, pid = 1, 0
        self._write({
            "kind": "header",
            "engine": engine,
            "scenario": scenario,
            "params": params or {},
            "toolchain": toolchain_fingerprint(),
            "git_commit": git_commit(),
            "mesh_budget": mesh_budget_fingerprint(),
            # the kernel build cache's outcome (util/accel.py): where the
            # libraries are built, or why the cache could not be configured
            "compile_cache": cache_status(),
            "process_count": pc,
            "process_id": pid,
        })

    def block(self, record: dict, **extra) -> None:
        self._write({"kind": "block", **_to_host({**record, **extra})})

    def score(self, record: dict) -> None:
        """Append a chaos-scenario verdict (``chaos.score_blocks``)."""
        self._write({**_to_host(record), "kind": "score"})

    def span(self, record: dict) -> None:
        """Append one ``kind: "span"`` record (host scalars)."""
        self._write({**record, "kind": "span"})

    def _write(self, obj: dict) -> None:
        self._f.write(json.dumps(obj, sort_keys=True) + "\n")

    def close(self) -> None:
        self._f.flush()
        self._f.close()

    def __enter__(self) -> "TelemetryJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_journal(path: str) -> list[dict]:
    """Parse a JSONL journal back into records."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- event bus + StatsReporter bridge ----------------------------------------

SIM_STAT_PREFIX = "ringpop.sim"

# record field -> (statsd method, key suffix), the host plane's vocabulary
# (OBSERVABILITY.md's key table)
STAT_KEYS = {
    "ping_send": ("incr", "ping.send"),
    "ping_req_send": ("incr", "ping-req.send"),
    "ping_timeout": ("incr", "ping.timeout"),
    "refuted": ("incr", "refuted-update"),
    "rumors_piggybacked": ("incr", "changes.disseminate"),
    "rumors_expired": ("incr", "changes.expired"),
    "timer_fired": ("incr", "state-timer.fired"),
    "decl_alive": ("incr", "membership-update.alive"),
    "decl_suspect": ("incr", "membership-update.suspect"),
    "decl_faulty": ("incr", "membership-update.faulty"),
    "decl_tombstone": ("incr", "membership-update.tombstone"),
    "heal_attempts": ("incr", "heal.attempt"),
    "num_members": ("gauge", "num-members"),
    "census_alive": ("gauge", "membership.alive"),
    "census_suspect": ("gauge", "membership.suspect"),
    "census_faulty": ("gauge", "membership.faulty"),
    "census_tombstone": ("gauge", "membership.tombstone"),
    "rumors_active": ("gauge", "rumors.active"),
    "detect_frac": ("gauge", "detection.fraction"),
}

# topology-plane block keys (tier-armed topology runs), under ringpop.sim.topo.*
for _tk, _dash in zip(TIER_KEYS, TIER_NAMES):
    STAT_KEYS[f"suspects_{_tk}"] = ("incr", f"topo.suspects.{_dash}")
    STAT_KEYS[f"false_suspects_{_tk}"] = ("incr", f"topo.false-suspects.{_dash}")
STAT_KEYS["refuted_unreachable_dir"] = ("incr", "topo.refuted.unreachable-dir")
STAT_KEYS["refuted_reachable_dir"] = ("incr", "topo.refuted.reachable-dir")


def emit_stats(reporter, record: dict, prefix: str = SIM_STAT_PREFIX) -> None:
    """Feed a fetched block record into a ``StatsReporter``
    (``options.py``) under the sim namespace."""
    record = _to_host(record)
    for field, (kind, suffix) in STAT_KEYS.items():
        if field not in record:
            continue
        if kind == "incr":
            reporter.incr(f"{prefix}.{suffix}", int(record[field]))
        else:
            reporter.gauge(f"{prefix}.{suffix}", float(record[field]))


class TelemetrySink:
    """Fan a fetched block record out to any of: a JSONL journal, a
    ``StatsReporter``, an event emitter (``events.EventEmitter``, as a
    ``SimTickBlockEvent``) and a plain callable — the one object
    ``LifecycleSim`` and ``DeltaSim`` attach."""

    def __init__(
        self,
        journal: Optional[TelemetryJournal] = None,
        stats=None,
        emitter=None,
        fn: Optional[Callable[[dict], None]] = None,
        stat_prefix: str = SIM_STAT_PREFIX,
    ):
        self.journal = journal
        self.stats = stats
        self.emitter = emitter
        self.fn = fn
        self.stat_prefix = stat_prefix
        self.records: list = []  # host-side history (cheap; per block)

    def __call__(self, record: dict, **extra: Any) -> None:
        host = _to_host({**record, **extra})
        self.records.append(host)
        if self.journal is not None:
            self.journal.block(host)
        if self.stats is not None:
            emit_stats(self.stats, host, self.stat_prefix)
        if self.emitter is not None:
            from ringpop_tpu_torch.events import SimTickBlockEvent

            self.emitter.emit(SimTickBlockEvent(record=host))
        if self.fn is not None:
            self.fn(host)


# -- carrying a JAX accumulator across ------------------------------------------


def telemetry_from_numpy(leaves, device: DeviceLike = None) -> TelemetryState:
    """A ``TelemetryState`` on ``device`` from the JAX package's (any
    object with its field names, or a sequence in its field order, as
    numpy-convertible arrays; None legs stay None): the uint32 planes cross
    as their int32 bit pattern."""
    dev = resolve_device(device)
    if not hasattr(leaves, "_fields"):
        leaves = dict(zip(TelemetryState._fields, leaves))
    else:
        leaves = leaves._asdict()
    out = {}
    for name in TelemetryState._fields:
        leaf = leaves.get(name)
        if leaf is None:
            out[name] = None
            continue
        arr = np.asarray(leaf)
        arr = arr.astype(np.uint32).view(np.int32) if name in ("piggybacked", "expired") else arr.astype(np.int32)
        out[name] = torch.as_tensor(np.array(arr), device=dev)
    return TelemetryState(**out)
