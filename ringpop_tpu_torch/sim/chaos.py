"""Chaos plane: time-varying fault scenarios with convergence scoring.

Counterpart of ``ringpop_tpu/sim/chaos.py``, leg for leg:

1. **FaultPlan** — a declarative scenario timeline compiled on the host,
   once, into dense per-node tensors on the engines' device: crash/restart
   windows, flapping schedules, a partition window with an optional
   directed ``reach[G, G]`` matrix, scalar and per-node loss, the topology
   legs (``sim/topology.py``) and a suspicion-timeout override.
2. **faults_at(plan, tick)** — the evaluator the engines reach through
   ``delta.resolve_faults`` at the top of every step and query: every
   output leg is an elementwise function of the plan's [N] legs and the
   tick, computed on the plan's device (the state's ``tick`` is a 0-d
   tensor there, so no host sync a tick).  A constant plan (static legs
   only) returns its legs untouched.
3. **score_blocks** — the convergence scorer: a telemetry journal's block
   records and the plan's event timeline reduced to a scenario verdict
   (time to detect a crash event, rumor half-life, false-positive suspects,
   re-join convergence, the per-tier and directed-partition breakdowns).

The builders and the scorer are numpy on the host; only ``faults_at``
touches the device.  Builders take ``device`` (the card unless the caller
asks for the CPU), as the engines' entry points do.  Plans batch: a leg with
one more axis than its solo rank carries a leading scenario axis
(``stack_plans``, ``index_plan``, ``slice_plan``).

Under a (P, R) mesh a plan is whole on every rank, on the rank's device:
the partition table names its [N] legs ``P("node")`` and ``tier_ids``
``P(None, "node")``, as the JAX package's does, but the engines evaluate
``faults_at`` whole (every [N] vector of a tick is whole on every rank)
and cut their own rows out, which is bit-equal and needs no gather.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.sim.delta import N_TIERS, TIER_LEVELS, TIER_NAMES, DeltaFaults

# "this never happens" tick sentinel (the engines' NO_DEADLINE): comparisons
# against it are false for real ticks
NO_TICK = np.int32(np.iinfo(np.int32).max)

# leg -> dtype (the JAX package's dtypes; the port's tensors hold the same)
LEG_DTYPES = {
    "base_up": torch.bool, "crash_tick": torch.int32, "restart_tick": torch.int32,
    "flap_period": torch.int32, "flap_phase": torch.int32, "flap_down": torch.int32,
    "group": torch.int32, "part_from": torch.int32, "part_until": torch.int32, "reach": torch.bool,
    "drop_rate": torch.float32, "drop_node": torch.float32, "tier_ids": torch.int32,
    "tier_drop": torch.float32, "suspect_ticks": torch.int32,
}


class FaultPlan(NamedTuple):
    """A compiled scenario timeline (tensors on one device); every leg is
    optional.  A node is up iff no liveness leg holds it down: ``base_up``
    (the permanent crash set), the crash window ``[crash_tick,
    restart_tick)`` (``NO_TICK`` = never), and flapping (``flap_down``
    ticks down out of every ``flap_period``, offset by ``flap_phase``).
    ``group`` (with the optional directed ``reach``) applies only inside
    ``[part_from, part_until)``; outside it every node reports group -1.
    The loss, topology and ``suspect_ticks`` legs pass through.  Ticks are
    the engine clock: tick t's exchange sees ``faults_at(plan, t)``."""

    base_up: Optional[torch.Tensor] = None  # bool[N]
    crash_tick: Optional[torch.Tensor] = None  # int32[N], NO_TICK = never
    restart_tick: Optional[torch.Tensor] = None  # int32[N], NO_TICK = never
    flap_period: Optional[torch.Tensor] = None  # int32[N], 0 = not flapping
    flap_phase: Optional[torch.Tensor] = None  # int32[N]
    flap_down: Optional[torch.Tensor] = None  # int32[N] down ticks per period
    group: Optional[torch.Tensor] = None  # int32[N], -1 = unpartitioned
    part_from: Optional[torch.Tensor] = None  # int32[] split tick (None = 0)
    part_until: Optional[torch.Tensor] = None  # int32[] heal tick (None = never)
    reach: Optional[torch.Tensor] = None  # bool[G, G] directed reachability
    drop_rate: Optional[torch.Tensor] = None  # float32[] scalar loss
    drop_node: Optional[torch.Tensor] = None  # float32[N] per-node loss
    tier_ids: Optional[torch.Tensor] = None  # int32[TIER_LEVELS, N] topology ids
    tier_drop: Optional[torch.Tensor] = None  # float32[N_TIERS] per-tier loss
    suspect_ticks: Optional[torch.Tensor] = None  # int32[] timeout (-1 = params)

    def at_tick(self, tick) -> DeltaFaults:
        """The seam ``delta.resolve_faults`` dispatches on."""
        return faults_at(self, tick)


def _leg(field: str, value, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.array(value), device=device).to(LEG_DTYPES[field])


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plan_from_numpy(plan, device: DeviceLike = None) -> FaultPlan:
    """A ``FaultPlan`` on ``device`` from the JAX package's (any object with
    its leg names, or a dict of them, as numpy-convertible arrays; missing
    or None legs stay None)."""
    dev = resolve_device(device)
    legs = {}
    for field in FaultPlan._fields:
        value = plan.get(field) if isinstance(plan, dict) else getattr(plan, field, None)
        if value is not None:
            legs[field] = _leg(field, value, dev)
    return FaultPlan(**legs)


def faults_at(plan: FaultPlan, tick) -> DeltaFaults:
    """Evaluate the plan's timeline at ``tick`` (an int or a 0-d tensor):
    a ``DeltaFaults`` of tensors on the plan's device, every op
    elementwise."""
    t = torch.as_tensor(tick, dtype=torch.int32)
    up = plan.base_up
    if plan.crash_tick is not None:
        down = t >= plan.crash_tick
        if plan.restart_tick is not None:
            down &= t < plan.restart_tick
        up = ~down if up is None else up & ~down
    if plan.flap_period is not None:
        if plan.flap_down is None:
            raise ValueError("flap_period without flap_down: how long is a flap?")
        period = plan.flap_period.clamp_min(1)
        phase = plan.flap_phase if plan.flap_phase is not None else 0
        pos = torch.remainder(t + phase, period)
        flapped = (plan.flap_period > 0) & (pos < plan.flap_down)
        up = ~flapped if up is None else up & ~flapped
    group = plan.group
    if group is not None and (plan.part_from is not None or plan.part_until is not None):
        in_part = torch.ones((), dtype=torch.bool, device=group.device)
        if plan.part_from is not None:
            in_part = in_part & (t >= plan.part_from)
        if plan.part_until is not None:
            in_part = in_part & (t < plan.part_until)
        group = torch.where(in_part, group, -1)
    return DeltaFaults(
        up=up,
        group=group,
        drop_rate=plan.drop_rate,
        drop_node=plan.drop_node,
        reach=plan.reach,
        tier_ids=plan.tier_ids,
        tier_drop=plan.tier_drop,
        suspect_ticks=plan.suspect_ticks,
    )


def constant_plan(faults: DeltaFaults) -> FaultPlan:
    """A FaultPlan encoding a static DeltaFaults: ``faults_at`` returns the
    same legs, so runs are bit-identical to running the DeltaFaults."""
    return FaultPlan(
        base_up=faults.up,
        group=faults.group,
        reach=faults.reach,
        drop_rate=faults.drop_rate,
        drop_node=faults.drop_node,
        tier_ids=faults.tier_ids,
        tier_drop=faults.tier_drop,
        suspect_ticks=faults.suspect_ticks,
    )


# -- plan validation (host-side, at build time) -------------------------------


def validate_plan(plan: FaultPlan) -> FaultPlan:
    """Host-side structural validation of a (solo or stacked) plan, called
    by every builder here and in ``sim/topology.py``: ``reach`` square and
    boolean; every ``group`` id >= -1 and inside the ``reach`` extent; the
    topology legs as a pair of the fixed shapes (``tier_ids`` [3, N],
    ``tier_drop`` [4] in [0, 1]); ``suspect_ticks`` >= 1 or the -1
    sentinel; ``flap_period`` with ``flap_down``.  Returns the plan."""
    if plan.reach is not None:
        reach = _np(plan.reach)
        if reach.ndim not in (2, 3) or reach.shape[-1] != reach.shape[-2]:
            raise ValueError(
                f"reach must be a square [G, G] matrix (stacked: [B, G, G]); got shape {reach.shape}")
        if reach.dtype != np.bool_:
            raise ValueError(
                f"reach must be boolean (directed reachability verdicts); got dtype {reach.dtype} — cast "
                "explicitly if you mean it")
    if plan.group is not None:
        group = _np(plan.group)
        if group.size and int(group.min()) < -1:
            raise ValueError(f"group ids must be >= -1 (-1 = unpartitioned); min is {int(group.min())}")
        if plan.reach is not None and group.size:
            g_extent = int(_np(plan.reach).shape[-1])
            g_max = int(group.max())
            if g_max >= g_extent:
                raise ValueError(
                    f"group id {g_max} is out of range for the [{g_extent}, {g_extent}] reach matrix — an "
                    "oversized id would silently clamp into another group's row at evaluation time")
    if (plan.tier_ids is None) != (plan.tier_drop is None):
        raise ValueError("topology legs come as a pair: tier_ids (int32[3, N]) and tier_drop (float32[4])")
    if plan.tier_ids is not None:
        ids = _np(plan.tier_ids)
        if ids.shape[-2] != TIER_LEVELS:
            raise ValueError(
                f"tier_ids must carry the fixed {TIER_LEVELS}-level rack/zone/region hierarchy on axis -2; "
                f"got shape {ids.shape}")
        table = _np(plan.tier_drop)
        if table.shape[-1] != N_TIERS:
            raise ValueError(
                f"tier_drop must have one entry per tier distance ({N_TIERS}: {', '.join(TIER_NAMES)}); got "
                f"shape {table.shape}")
        if table.size and (float(table.min()) < 0.0 or float(table.max()) > 1.0):
            raise ValueError(
                f"tier_drop entries are loss probabilities in [0, 1]; got range [{float(table.min())}, "
                f"{float(table.max())}]")
    if plan.suspect_ticks is not None:
        st = _np(plan.suspect_ticks)
        if bool(((st < 1) & (st != -1)).any()):
            raise ValueError(
                "suspect_ticks must be >= 1 (or the -1 'use params' sentinel); got "
                f"{st.tolist() if st.ndim else int(st)}")
    if plan.flap_period is not None and plan.flap_down is None:
        raise ValueError("flap_period without flap_down: how long is a flap?")
    return plan


# -- scenario builders (host-side numpy; tensors on the device out) -----------


def churn_plan(n: int, *, n_churn: Optional[int] = None, n_permanent: int = 0, first: int = 8, stagger: int = 8,
               waves: int = 4, down_ticks: int = 64, seed: int = 0, device: DeviceLike = None) -> FaultPlan:
    """Crash/restart churn: ``n_churn`` nodes (default ~1%) crash in
    ``waves`` staggered waves from tick ``first``, each down for
    ``down_ticks``; the first ``n_permanent`` of them never restart."""
    dev = resolve_device(device)
    if n_churn is None:
        n_churn = max(4, n // 100)
    rng = np.random.default_rng(seed)
    nodes = rng.choice(n, size=min(n_churn, n), replace=False)
    crash = np.full(n, NO_TICK, np.int32)
    restart = np.full(n, NO_TICK, np.int32)
    for j, node in enumerate(nodes):
        t = first + (j % waves) * stagger
        crash[node] = t
        if j >= n_permanent:
            restart[node] = t + down_ticks
    return FaultPlan(crash_tick=_leg("crash_tick", crash, dev), restart_tick=_leg("restart_tick", restart, dev))


def flap_plan(n: int, *, n_flap: Optional[int] = None, period: int = 24, down: int = 6, start: int = 8,
              seed: int = 0, device: DeviceLike = None) -> FaultPlan:
    """Flapping members: ``n_flap`` nodes (default ~1%) down ``down`` ticks
    out of every ``period``, phases staggered; ``start`` delays the first
    down phase."""
    dev = resolve_device(device)
    if n_flap is None:
        n_flap = max(2, n // 100)
    rng = np.random.default_rng(seed)
    nodes = rng.choice(n, size=min(n_flap, n), replace=False)
    fperiod = np.zeros(n, np.int32)
    fphase = np.zeros(n, np.int32)
    fdown = np.zeros(n, np.int32)
    for j, node in enumerate(nodes):
        fperiod[node] = period
        # the node's first down window opens at start + j (staggered)
        fphase[node] = (-(start + j)) % period
        fdown[node] = down
    return FaultPlan(flap_period=_leg("flap_period", fperiod, dev), flap_phase=_leg("flap_phase", fphase, dev),
                     flap_down=_leg("flap_down", fdown, dev))


def asym_partition_plan(n: int, *, minority: float = 0.3, split_at: int = 8, heal_at: int = 128,
                        device: DeviceLike = None) -> FaultPlan:
    """One-way partition window: the first ``minority`` fraction of nodes is
    group 1 during ``[split_at, heal_at)``; majority → minority is blocked,
    minority → majority delivers."""
    dev = resolve_device(device)
    group = np.zeros(n, np.int32)
    group[: int(minority * n)] = 1
    reach = np.asarray([[True, False], [True, True]])
    return FaultPlan(
        group=_leg("group", group, dev),
        part_from=_leg("part_from", np.int32(split_at), dev),
        part_until=_leg("part_until", np.int32(heal_at), dev),
        reach=_leg("reach", reach, dev),
    )


def _merge_plans(*plans: FaultPlan) -> FaultPlan:
    """Combine plans with disjoint legs (a leg set in two plans is a
    construction error)."""
    merged = {}
    for plan in plans:
        for field, value in zip(plan._fields, plan):
            if value is None:
                continue
            if merged.get(field) is not None:
                raise ValueError(f"leg {field!r} set by more than one plan")
            merged[field] = value
    return validate_plan(FaultPlan(**merged))


def scenario_plan(name: str, n: int, seed: int = 0, horizon: int = 256, device: DeviceLike = None) -> FaultPlan:
    """The canonical simbench / chaos-smoke scenario plans (``churn``,
    ``flap``, ``asym``, ``smoke``), parameterized only by (name, n, seed,
    horizon); schedules scale with ``horizon``."""
    dev = resolve_device(device)
    if name == "churn":
        return validate_plan(churn_plan(
            n, n_churn=max(8, n // 100), n_permanent=max(2, n // 400), first=max(4, horizon // 32),
            stagger=max(4, horizon // 32), waves=4, down_ticks=max(16, horizon // 4), seed=seed, device=dev))
    if name == "flap":
        return _merge_plans(
            flap_plan(n, n_flap=max(4, n // 100), period=max(12, horizon // 10), down=max(3, horizon // 40),
                      start=max(4, horizon // 32), seed=seed, device=dev),
            # background loss keeps the indirect-probe machinery busy
            FaultPlan(drop_rate=_leg("drop_rate", np.float32(0.02), dev)),
        )
    if name == "asym":
        # a small permanent crash cohort rides along: time to detect
        # through the one-way window
        return _merge_plans(
            asym_partition_plan(n, minority=0.3, split_at=max(4, horizon // 32), heal_at=horizon // 2, device=dev),
            churn_plan(n, n_churn=max(2, n // 1000), n_permanent=max(2, n // 1000), first=2, stagger=1, waves=1,
                       seed=seed, device=dev),
        )
    if name == "smoke":
        # tiny churn + flap + loss: every time-varying leg in one plan
        return _merge_plans(
            churn_plan(n, n_churn=max(4, n // 64), n_permanent=2, first=4, stagger=4, waves=2,
                       down_ticks=max(12, horizon // 4), seed=seed, device=dev),
            flap_plan(n, n_flap=max(2, n // 64), period=12, down=3, start=6, seed=seed + 1, device=dev),
            FaultPlan(drop_rate=_leg("drop_rate", np.float32(0.02), dev)),
        )
    raise ValueError(f"unknown chaos scenario {name!r}")


# -- plan batching: B scenarios as one [B, ...] plan --------------------------

# solo (unbatched) ndim per leg: a leaf with one more axis carries a leading
# scenario axis
PLAN_LEG_NDIM = {
    "base_up": 1, "crash_tick": 1, "restart_tick": 1, "flap_period": 1, "flap_phase": 1, "flap_down": 1,
    "group": 1, "part_from": 0, "part_until": 0, "reach": 2, "drop_rate": 0, "drop_node": 1, "tier_ids": 2,
    "tier_drop": 1, "suspect_ticks": 0,
}


def _leg_rank(field: str, value) -> int:
    nd = int(getattr(value, "ndim", 0))
    solo = PLAN_LEG_NDIM[field]
    if nd not in (solo, solo + 1):
        raise ValueError(f"plan leg {field!r} has ndim {nd}; expected {solo} (solo) or {solo + 1} (stacked [B, ...])")
    return nd - solo


def plan_axes(plan: FaultPlan) -> Optional[FaultPlan]:
    """The batch axes of a (possibly) stacked plan: 0 for legs carrying a
    leading scenario axis, None for shared legs — or None when nothing is
    batched."""
    axes = {}
    batched = False
    for field, value in zip(plan._fields, plan):
        if value is None:
            continue
        if _leg_rank(field, value):
            axes[field] = 0
            batched = True
    return FaultPlan(**axes) if batched else None


def plan_batch_size(plan: FaultPlan) -> Optional[int]:
    """B of a stacked plan (None for a solo plan); mixed batch sizes are a
    construction error."""
    sizes = {int(value.shape[0]) for field, value in zip(plan._fields, plan)
             if value is not None and _leg_rank(field, value)}
    if not sizes:
        return None
    if len(sizes) > 1:
        raise ValueError(f"stacked plan carries mixed batch sizes {sorted(sizes)}")
    return sizes.pop()


def _leg_default(field: str, n: Optional[int], groups: int, device: torch.device) -> torch.Tensor:
    """The inert default a member missing leg ``field`` stacks as: crash
    windows that never open, flap periods of zero, group -1 everywhere,
    loss 0.0, an identity ``reach``, a flat topology with a zero table, the
    -1 timeout sentinel."""
    dt = LEG_DTYPES[field]
    if field == "base_up":
        return torch.ones((n,), dtype=dt, device=device)
    if field in ("crash_tick", "restart_tick"):
        return torch.full((n,), int(NO_TICK), dtype=dt, device=device)
    if field in ("flap_period", "flap_phase", "flap_down"):
        return torch.zeros((n,), dtype=dt, device=device)
    if field == "group":
        return torch.full((n,), -1, dtype=dt, device=device)
    if field == "part_from":
        return torch.zeros((), dtype=dt, device=device)
    if field == "part_until":
        return torch.full((), int(NO_TICK), dtype=dt, device=device)
    if field == "reach":
        return torch.eye(groups, dtype=dt, device=device)
    if field == "drop_rate":
        return torch.zeros((), dtype=dt, device=device)
    if field == "drop_node":
        return torch.zeros((n,), dtype=dt, device=device)
    if field == "tier_ids":
        return torch.zeros((TIER_LEVELS, n), dtype=dt, device=device)
    if field == "tier_drop":
        return torch.zeros((N_TIERS,), dtype=dt, device=device)
    if field == "suspect_ticks":
        return torch.full((), -1, dtype=dt, device=device)
    raise ValueError(f"unknown plan leg {field!r}")


def _pad_reach(reach: torch.Tensor, groups: int) -> torch.Tensor:
    """Embed a [G, G] reach matrix in [groups, groups]: the original verdicts
    top-left, identity on the padded diagonal."""
    g = reach.shape[0]
    if g == groups:
        return reach
    out = torch.eye(groups, dtype=torch.bool, device=reach.device)
    out[:g, :g] = reach
    return out


def stack_plans(plans) -> FaultPlan:
    """Stack B solo FaultPlans into one plan whose legs carry a leading
    scenario axis.  A leg set by any member is materialized for every
    member (the missing ones take ``_leg_default``, value-identical to the
    leg's absence); a leg set by none stays None; ``reach`` matrices are
    padded to the largest group count (``_pad_reach``)."""
    plans = list(plans)
    if not plans:
        raise ValueError("stack_plans needs at least one plan")
    for p in plans:
        validate_plan(p)
        for field, value in zip(p._fields, p):
            if value is not None and _leg_rank(field, value):
                raise ValueError(f"stack_plans takes SOLO plans; {field!r} is already stacked")
    device = next((v.device for p in plans for v in p if v is not None), torch.device("cpu"))
    # n from any per-node leg (tier_ids carries the node axis last)
    n = next(
        (int(v.shape[-1]) if f == "tier_ids" else int(v.shape[0])
         for p in plans for f, v in zip(p._fields, p)
         if v is not None and (PLAN_LEG_NDIM[f] == 1 or f == "tier_ids")),
        None,
    )
    # the padded reach covers every member's group ids, the symmetric
    # members' too (their ids index the identity default)
    groups = max(
        [int(p.reach.shape[0]) for p in plans if p.reach is not None]
        + [int(_np(p.group).max()) + 1 for p in plans if p.group is not None],
        default=0,
    )
    legs = {}
    for field in FaultPlan._fields:
        values = [getattr(p, field) for p in plans]
        if all(v is None for v in values):
            continue
        if field == "reach":
            stacked = [_pad_reach(v, groups) if v is not None else _leg_default("reach", n, groups, device)
                       for v in values]
        else:
            if n is None and (PLAN_LEG_NDIM[field] == 1 or field == "tier_ids"):
                raise ValueError(f"cannot default per-node leg {field!r}: no member names n")
            default = None
            stacked = []
            for v in values:
                if v is None:
                    if default is None:
                        default = _leg_default(field, n, groups, device)
                    v = default
                stacked.append(v)
        legs[field] = torch.stack(stacked)
    return FaultPlan(**legs)


def index_plan(plan: FaultPlan, b: int) -> FaultPlan:
    """Member ``b`` of a stacked plan as a solo plan (batched legs sliced,
    shared legs passed through)."""
    legs = {}
    for field, value in zip(plan._fields, plan):
        if value is None:
            continue
        legs[field] = value[b] if _leg_rank(field, value) else value
    return FaultPlan(**legs)


def slice_plan(plan: FaultPlan, lo: int, hi: int) -> FaultPlan:
    """Members ``[lo, hi)`` of a stacked plan as a smaller stacked plan."""
    if not 0 <= lo <= hi:
        raise ValueError(f"bad slice [{lo}, {hi})")
    legs = {}
    for field, value in zip(plan._fields, plan):
        if value is None:
            continue
        legs[field] = value[lo:hi] if _leg_rank(field, value) else value
    return FaultPlan(**legs)


# -- host-side timeline introspection ----------------------------------------


def up_at_host(plan: FaultPlan, tick: int, n: int) -> np.ndarray:
    """Host-numpy mirror of the liveness legs of :func:`faults_at` (the
    scorer's ground truth for expected-alive counts)."""
    up = np.ones(n, bool)
    if plan.base_up is not None:
        up &= _np(plan.base_up)
    if plan.crash_tick is not None:
        down = tick >= _np(plan.crash_tick)
        if plan.restart_tick is not None:
            down &= tick < _np(plan.restart_tick)
        up &= ~down
    if plan.flap_period is not None:
        period = np.maximum(_np(plan.flap_period), 1)
        phase = _np(plan.flap_phase) if plan.flap_phase is not None else 0
        pos = np.mod(tick + phase, period)
        up &= ~((_np(plan.flap_period) > 0) & (pos < _np(plan.flap_down)))
    return up


def plan_events(plan: FaultPlan) -> list[dict]:
    """The plan's discrete event timeline, host-side: one record per
    distinct crash/restart tick (with the cohort size), the partition
    split/heal ticks, and a summary of the flapping population; sorted by
    tick."""
    events: list[dict] = []
    if plan.crash_tick is not None:
        crash = _np(plan.crash_tick)
        for t in np.unique(crash[crash != NO_TICK]):
            events.append({"kind": "crash", "tick": int(t), "nodes": int((crash == t).sum())})
    if plan.restart_tick is not None:
        restart = _np(plan.restart_tick)
        for t in np.unique(restart[restart != NO_TICK]):
            events.append({"kind": "restart", "tick": int(t), "nodes": int((restart == t).sum())})
    # an all -1 group leg (a stacked default) and part_until == NO_TICK
    # (the stacked "never heals") are not events
    if plan.group is not None and bool((_np(plan.group) >= 0).any()):
        split = int(_np(plan.part_from)) if plan.part_from is not None else 0
        events.append({"kind": "partition", "tick": split, "nodes": int((_np(plan.group) > 0).sum()),
                       "directed": plan.reach is not None})
        if plan.part_until is not None and int(_np(plan.part_until)) != NO_TICK:
            events.append({"kind": "heal", "tick": int(_np(plan.part_until))})
    if plan.flap_period is not None:
        period = _np(plan.flap_period)
        flappers = period > 0
        if flappers.any():
            phase = _np(plan.flap_phase) if plan.flap_phase is not None else np.zeros_like(period)
            first_down = np.where(flappers, np.mod(-phase, np.maximum(period, 1)), np.int64(NO_TICK))
            events.append({
                "kind": "flap",
                "tick": int(first_down[flappers].min()),
                "nodes": int(flappers.sum()),
                "period": int(period[flappers].max()),
                "down": int(_np(plan.flap_down)[flappers].max()),
            })
    events.sort(key=lambda e: e["tick"])
    return events


# -- the convergence scorer ---------------------------------------------------


def _first_crossing(ticks, series, after: int, level: float):
    """First journal tick >= ``after`` whose series value reaches ``level``
    (None if it never does)."""
    for t, v in zip(ticks, series):
        if t >= after and v >= level:
            return int(t)
    return None


def score_blocks(blocks: list[dict], plan: FaultPlan, *, n: int, scenario: str = "",
                 scenario_id: Optional[int] = None) -> dict:
    """Reduce a lifecycle run journal (its ``block`` records, in order) and
    the plan's event timeline into a scenario verdict, in ticks at the
    journal's block granularity: ``time_to_detect`` and ``rumor_half_life``
    per crash event (``detect_frac`` reaching 1 and 0.5), false-positive
    suspects (refutations less the plan's restarted nodes), re-join
    convergence after the last restart, and, where the blocks carry them,
    the quorum, per-tier and directed-partition breakdowns."""
    blocks = [b for b in blocks if b.get("kind", "block") == "block"]
    events = plan_events(plan)
    ticks = [int(b["tick"]) for b in blocks]
    detect = [float(b.get("detect_frac", 0.0)) for b in blocks]
    granularity = max((int(b.get("ticks", 0)) for b in blocks), default=0)
    total_ticks = ticks[-1] if ticks else 0

    crashes = [e for e in events if e["kind"] == "crash"]
    ttd, half = [], []
    for e in crashes:
        t_full = _first_crossing(ticks, detect, e["tick"], 1.0)
        t_half = _first_crossing(ticks, detect, e["tick"], 0.5)
        ttd.append([e["tick"], None if t_full is None else t_full - e["tick"]])
        half.append([e["tick"], None if t_half is None else t_half - e["tick"]])

    def _median(pairs):
        vals = sorted(v for _, v in pairs if v is not None)
        return vals[len(vals) // 2] if vals else None

    restarts = [e for e in events if e["kind"] == "restart"]
    restarted_nodes = sum(e["nodes"] for e in restarts)
    refutations = int(sum(b.get("refuted", 0) for b in blocks))
    rejoin = None
    if restarts and blocks:
        last_restart = max(e["tick"] for e in restarts)
        expected_alive = int(up_at_host(plan, total_ticks, n).sum())
        for b in blocks:
            if (int(b["tick"]) >= last_restart and int(b.get("census_alive", -1)) >= expected_alive
                    and int(b.get("rumors_active", 1)) == 0):
                rejoin = int(b["tick"]) - last_restart
                break

    out = {
        "kind": "score",
        "scenario": scenario,
        "n": n,
        "ticks": total_ticks,
        "blocks": len(blocks),
        "block_granularity_ticks": granularity,
        "events": events,
        "time_to_detect": ttd,
        "time_to_detect_median": _median(ttd),
        "rumor_half_life": half,
        "rumor_half_life_median": _median(half),
        "refutations": refutations,
        "false_positive_suspects": max(0, refutations - restarted_nodes),
        "suspects_declared": int(sum(b.get("decl_suspect", 0) for b in blocks)),
        "faulty_declared": int(sum(b.get("decl_faulty", 0) for b in blocks)),
        "heal_attempts": int(sum(b.get("heal_attempts", 0) for b in blocks)),
        "final_detect_frac": detect[-1] if detect else None,
        "rejoin_convergence_ticks": rejoin,
    }
    qblocks = [b for b in blocks if "quorum_ok_frac" in b]
    if qblocks:
        out["quorum_ok_frac_min"] = min(float(b["quorum_ok_frac"]) for b in qblocks)
        out["quorum_acks_min"] = min(int(b.get("quorum_acks_min", 0)) for b in qblocks)
    # topology journals: the per-tier suspicion flow that tells a zone cut
    # from as many independent crashes
    tier_keys = [nm.replace("-", "_") for nm in TIER_NAMES]
    tblocks = [b for b in blocks if f"suspects_{tier_keys[0]}" in b]
    if tblocks:
        out["suspects_by_tier"] = {k: int(sum(b.get(f"suspects_{k}", 0) for b in tblocks)) for k in tier_keys}
        out["false_positive_by_tier"] = {
            k: int(sum(b.get(f"false_suspects_{k}", 0) for b in tblocks)) for k in tier_keys}
        anchor = min((e["tick"] for e in events if e["kind"] in ("crash", "partition", "flap")), default=None)
        ttd_tier: dict = {}
        for k in tier_keys:
            first = None
            if anchor is not None:
                for b in tblocks:
                    if int(b["tick"]) >= anchor and float(b.get(f"suspects_{k}", 0)) > 0:
                        first = int(b["tick"]) - anchor
                        break
            ttd_tier[k] = first
        out["time_to_detect_by_tier"] = ttd_tier
    dblocks = [b for b in blocks if "refuted_unreachable_dir" in b]
    if dblocks:
        out["refutations_unreachable_dir"] = int(sum(b.get("refuted_unreachable_dir", 0) for b in dblocks))
        out["refutations_reachable_dir"] = int(sum(b.get("refuted_reachable_dir", 0) for b in dblocks))
    if scenario_id is not None:
        out["scenario_id"] = int(scenario_id)
    return out


# -- stats bridge -------------------------------------------------------------

CHAOS_STAT_PREFIX = "ringpop.sim.chaos"

# score field -> (statsd method, key suffix) under the chaos namespace
CHAOS_STAT_KEYS = {
    "time_to_detect_median": ("gauge", "time-to-detect"),
    "rumor_half_life_median": ("gauge", "rumor.half-life"),
    "false_positive_suspects": ("gauge", "false-positive.suspects"),
    "rejoin_convergence_ticks": ("gauge", "rejoin.convergence"),
    "final_detect_frac": ("gauge", "detection.fraction"),
}


def emit_score_stats(reporter, score: dict, prefix: str = CHAOS_STAT_PREFIX) -> None:
    """Feed a scenario verdict into a ``StatsReporter`` under
    ``ringpop.sim.chaos.*`` (null metrics are skipped, not zeroed)."""
    for field, (kind, suffix) in CHAOS_STAT_KEYS.items():
        value = score.get(field)
        if value is None:
            continue
        assert kind == "gauge"
        reporter.gauge(f"{prefix}.{suffix}", float(value))
