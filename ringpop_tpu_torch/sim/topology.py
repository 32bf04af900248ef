"""Topology compiler: rack/zone/region trees -> tier-realistic fault overlays
and correlated-failure scenarios.

Counterpart of ``ringpop_tpu/sim/topology.py``, table for table:

1. **Declarative tree** — :class:`TopologySpec`: region/zone/rack counts
   plus per-edge latency and loss (:class:`TierLink`).
   :func:`compile_topology` assigns nodes to racks in contiguous equal
   blocks and compiles the tree on the host to per-node tier ids
   ``tier_ids[3, N]`` and one per-tier loss table ``tier_drop[4]`` (a late
   ack is a lost leg: ``P(rtt > timeout)`` folds into the tier's loss).
2. **Device evaluation** — the compiled legs ride ``chaos.FaultPlan``; the
   engines classify each leg's tier and draw its loss coin with the tier
   legs already in the port (``delta.tier_pair``, ``tier_pair_drop``).
3. **Correlated events** — zone loss, switch flap, WAN partition and the
   independent-crash control, all compiled to the existing FaultPlan legs,
   so they stack and score through ``sim/chaos.py``.

A tree with no penalties compiles to no tier legs at all.  The builders
take ``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.sim import chaos
from ringpop_tpu_torch.sim.chaos import NO_TICK, FaultPlan
from ringpop_tpu_torch.sim.delta import N_TIERS, TIER_LEVELS, TIER_NAMES

__all__ = [
    "TierLink",
    "TopologySpec",
    "Topology",
    "compile_topology",
    "default_topology",
    "zone_loss_plan",
    "switch_flap_plan",
    "partition_plan",
    "independent_crash_plan",
    "topo_scenario_plan",
    "topo_scenario_specs",
    "emit_topo_stats",
    "late_ack_prob",
]


@dataclass(frozen=True)
class TierLink:
    """One edge class of the tree: the extra round-trip latency and the
    per-leg loss probability a message pays for crossing it (rack
    uplink, zone aggregation hop, or WAN link)."""

    rtt_ms: float = 0.0  # added round-trip latency across this edge
    loss: float = 0.0  # per-traversal loss probability


@dataclass(frozen=True)
class TopologySpec:
    """The declarative tree: counts per level plus per-edge parameters.
    Node → rack assignment is contiguous equal blocks (rack 0 owns the
    first ``n / racks`` nodes, ...), zones group consecutive racks,
    regions consecutive zones — so topology boundaries coincide with
    node-axis block boundaries."""

    regions: int = 1
    zones_per_region: int = 1
    racks_per_zone: int = 1
    rack_link: TierLink = field(default_factory=TierLink)
    zone_link: TierLink = field(default_factory=TierLink)
    region_link: TierLink = field(default_factory=TierLink)
    # probe timeout the per-tier latency is judged against (the engines'
    # protocol period is 200 ms; the reference's ping timeout spans
    # multiple periods, so 400 ms is the default judgment window)
    probe_timeout_ms: float = 400.0

    @property
    def total_racks(self) -> int:
        return self.regions * self.zones_per_region * self.racks_per_zone

    @property
    def total_zones(self) -> int:
        return self.regions * self.zones_per_region


def late_ack_prob(rtt_ms: float, timeout_ms: float) -> float:
    """P(ack arrives after the probe timeout) for a leg whose round trip
    has MEAN ``rtt_ms`` — exponential tail model, ``exp(-timeout/rtt)``.
    The exponential is deliberately heavy-tailed for a network RTT
    (queueing delay dominates the tail), which is the conservative
    choice for a fault overlay: it overestimates late acks rather than
    declaring a boundary loss-free.  0 when the tier adds no latency."""
    if rtt_ms <= 0.0:
        return 0.0
    return float(math.exp(-timeout_ms / rtt_ms))


@dataclass(frozen=True)
class Topology:
    """A compiled tree: per-node tier ids + the per-tier drop table, plus
    the host-side index structure the correlated-event builders consume.
    ``tier_ids`` rows are [rack, zone, region] (globally unique ids per
    level); ``tier_drop[t]`` is the per-leg loss at tier distance t
    (``delta.TIER_NAMES`` order)."""

    spec: TopologySpec
    n: int
    tier_ids: np.ndarray  # int32[TIER_LEVELS, N]
    tier_drop: np.ndarray  # float32[N_TIERS]

    # -- host-side index helpers --------------------------------------------

    def nodes_in_rack(self, rack: int) -> np.ndarray:
        return np.flatnonzero(self.tier_ids[0] == rack)

    def nodes_in_zone(self, zone: int) -> np.ndarray:
        return np.flatnonzero(self.tier_ids[1] == zone)

    def nodes_in_region(self, region: int) -> np.ndarray:
        return np.flatnonzero(self.tier_ids[2] == region)

    def tier_of_pair(self, a, b) -> np.ndarray:
        """Host mirror of ``delta.tier_pair`` (the scorer/test oracle)."""
        a = np.asarray(a, np.int64)
        b = np.asarray(b, np.int64)
        return (self.tier_ids[:, a] != self.tier_ids[:, b]).astype(np.int32).sum(axis=0)

    def has_penalties(self) -> bool:
        return bool((self.tier_drop > 0.0).any())

    def plan_legs(self, force: bool = False, device: DeviceLike = None) -> FaultPlan:
        """The topology as FaultPlan legs on ``device``.  A penalty-free
        tree returns the EMPTY plan — no tier leg at all, so a constant
        (penalty-free) topology runs the flat fault-plan step.
        ``force=True`` materializes the legs anyway (a zero table),
        bit-equal to the flat run by the separate-coin construction
        (``delta.tier_pair_drop``)."""
        if not force and not self.has_penalties():
            return FaultPlan()
        dev = resolve_device(device)
        return chaos.validate_plan(
            FaultPlan(
                tier_ids=chaos._leg("tier_ids", self.tier_ids, dev),
                tier_drop=chaos._leg("tier_drop", self.tier_drop, dev),
            )
        )


def _tier_table(spec: TopologySpec) -> np.ndarray:
    """Compile the per-edge parameters into the per-tier drop table.
    Tier t's path crosses every edge class up to its level TWICE (out
    through a's side of the tree, down into b's): loss composes as the
    survival product, latency sums into the mean RTT judged against the
    probe timeout (:func:`late_ack_prob`).  Same-rack (tier 0) pays
    nothing — intra-rack latency is far inside any timeout."""
    links = (spec.rack_link, spec.zone_link, spec.region_link)
    table = np.zeros(N_TIERS, np.float32)
    for t in range(1, N_TIERS):
        crossed = links[:t]
        survive = 1.0
        rtt = 0.0
        for link in crossed:
            survive *= (1.0 - float(link.loss)) ** 2
            rtt += 2.0 * float(link.rtt_ms)
        p_late = late_ack_prob(rtt, spec.probe_timeout_ms)
        table[t] = np.float32(1.0 - survive * (1.0 - p_late))
    return table


def compile_topology(spec: TopologySpec, n: int) -> Topology:
    """Compile the declarative tree for an ``n``-node cluster.

    Host-side, once: rack of node i is ``i * racks // n`` (contiguous
    near-equal blocks — a rack never straddles more shard boundaries
    than it must), zone/region ids derive by integer division, and the
    per-edge parameters fold into the ``tier_drop`` table.  Raises when
    the tree has more racks than nodes (an empty rack is a spec error,
    not a scenario)."""
    racks = spec.total_racks
    if racks < 1:
        raise ValueError(f"topology needs at least one rack; spec gives {racks}")
    if racks > n:
        raise ValueError(
            f"{racks}-rack tree over {n} nodes leaves empty racks — "
            "shrink the tree or grow the cluster"
        )
    for name, link in (
        ("rack_link", spec.rack_link),
        ("zone_link", spec.zone_link),
        ("region_link", spec.region_link),
    ):
        if not (0.0 <= float(link.loss) < 1.0):
            raise ValueError(f"{name}.loss must be in [0, 1); got {link.loss}")
        if float(link.rtt_ms) < 0.0:
            raise ValueError(f"{name}.rtt_ms must be >= 0; got {link.rtt_ms}")
    i = np.arange(n, dtype=np.int64)
    rack = (i * racks) // n
    zone = rack // spec.racks_per_zone
    region = zone // spec.zones_per_region
    tier_ids = np.stack([rack, zone, region]).astype(np.int32)
    assert tier_ids.shape == (TIER_LEVELS, n)
    return Topology(spec=spec, n=n, tier_ids=tier_ids, tier_drop=_tier_table(spec))


def default_topology(n: int, **overrides) -> Topology:
    """The canonical small tree the smoke/bench scenarios share: 2
    regions × 2 zones × 2 racks (8 racks), a quiet rack fabric, a lossy
    zone hop, and a WAN link whose 120 ms RTT inflates cross-region
    probe timeouts (``late_ack_prob`` ≈ 0.036 at the 400 ms window) on
    top of its 2% loss.  ``overrides`` replace TopologySpec fields."""
    spec_kw = dict(
        regions=2,
        zones_per_region=2,
        racks_per_zone=2,
        rack_link=TierLink(rtt_ms=0.2, loss=0.0),
        zone_link=TierLink(rtt_ms=2.0, loss=0.005),
        region_link=TierLink(rtt_ms=60.0, loss=0.02),
    )
    spec_kw.update(overrides)
    return compile_topology(TopologySpec(**spec_kw), n)


# -- correlated-failure scenario builders -------------------------------------


def _crash_legs(crash: np.ndarray, restart: np.ndarray, device: DeviceLike) -> FaultPlan:
    dev = resolve_device(device)
    return FaultPlan(crash_tick=chaos._leg("crash_tick", crash, dev),
                     restart_tick=chaos._leg("restart_tick", restart, dev))


def zone_loss_plan(
    topo: Topology,
    zone: int,
    *,
    at: int = 8,
    heal: Optional[int] = None,
    device: DeviceLike = None,
) -> FaultPlan:
    """A whole zone goes dark at tick ``at`` (power/cooling/aggregation
    failure — the canonical correlated event) and restarts at ``heal``
    (None = never).  Compiles to the existing crash/restart legs, so it
    batches and scores like any churn plan — but the crash set is a
    CONTIGUOUS tier block, which is exactly what the per-tier score
    split needs to distinguish from independent churn."""
    nodes = topo.nodes_in_zone(zone)
    if nodes.size == 0:
        raise ValueError(f"zone {zone} does not exist in this topology")
    crash = np.full(topo.n, NO_TICK, np.int32)
    restart = np.full(topo.n, NO_TICK, np.int32)
    crash[nodes] = at
    if heal is not None:
        restart[nodes] = heal
    return chaos.validate_plan(_crash_legs(crash, restart, device))


def switch_flap_plan(
    topo: Topology,
    rack: int,
    *,
    period: int = 24,
    down: int = 6,
    start: int = 8,
    device: DeviceLike = None,
) -> FaultPlan:
    """A rack's uplink flapping as ONE unit: every node behind the
    switch shares the identical period AND phase (unlike
    ``chaos.flap_plan``'s per-node staggering — the whole point of a
    correlated flap is that the cohort moves together).  The suspicion
    load it generates is bounded-from-outside only: inside the rack
    nothing changed."""
    dev = resolve_device(device)
    nodes = topo.nodes_in_rack(rack)
    if nodes.size == 0:
        raise ValueError(f"rack {rack} does not exist in this topology")
    fperiod = np.zeros(topo.n, np.int32)
    fphase = np.zeros(topo.n, np.int32)
    fdown = np.zeros(topo.n, np.int32)
    fperiod[nodes] = period
    fphase[nodes] = (-start) % period  # first down window opens at ``start``
    fdown[nodes] = down
    return chaos.validate_plan(
        FaultPlan(
            flap_period=chaos._leg("flap_period", fperiod, dev),
            flap_phase=chaos._leg("flap_phase", fphase, dev),
            flap_down=chaos._leg("flap_down", fdown, dev),
        )
    )


def partition_plan(
    topo: Topology,
    *,
    level: str = "region",
    cut: Sequence[int] = (1,),
    split_at: int = 8,
    heal_at: Optional[int] = None,
    one_way: bool = False,
    device: DeviceLike = None,
) -> FaultPlan:
    """A WAN/zone partition window: the ``cut`` ids at ``level`` (``"rack"``
    / ``"zone"`` / ``"region"``) become group 1 during ``[split_at,
    heal_at)``.  Symmetric by default — bit-identical legs to the
    hand-built symmetric-partition FaultPlan over the same node block
    (the topology-equivalence pin in tests/test_topology.py).
    ``one_way=True`` adds the directed ``reach`` the asym scenario
    established: majority → cut blocked, cut → majority delivering (the
    BGP-leak shape — the cut side still reaches out, nothing reaches
    in), so false accusations pile up about the cut side and refute
    through the open direction."""
    levels = {"rack": 0, "zone": 1, "region": 2}
    if level not in levels:
        raise ValueError(f"level must be one of {sorted(levels)}; got {level!r}")
    ids = topo.tier_ids[levels[level]]
    cut = sorted(int(c) for c in cut)
    if not cut:
        raise ValueError("partition_plan needs at least one cut id")
    present = set(np.unique(ids).tolist())
    missing = [c for c in cut if c not in present]
    if missing:
        raise ValueError(f"{level} ids {missing} do not exist in this topology")
    if len(cut) == len(present):
        raise ValueError(f"cutting every {level} partitions nothing from nothing")
    group = np.isin(ids, cut).astype(np.int32)
    dev = resolve_device(device)
    legs = dict(
        group=chaos._leg("group", group, dev),
        part_from=chaos._leg("part_from", np.int32(split_at), dev),
        part_until=chaos._leg("part_until", np.int32(heal_at if heal_at is not None else NO_TICK), dev),
    )
    if one_way:
        legs["reach"] = chaos._leg("reach", np.asarray([[True, False], [True, True]]), dev)
    return chaos.validate_plan(FaultPlan(**legs))


def independent_crash_plan(
    topo: Topology,
    n_crash: int,
    *,
    at: int = 8,
    heal: Optional[int] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> FaultPlan:
    """The control cohort: the SAME number of crashes as a correlated
    event, scattered uniformly over the cluster (the "100 independent
    crashes" a zone cut must NOT read as).  Same crash/restart legs,
    same tick schedule — only the correlation differs, so any score
    difference is the topology signal."""
    rng = np.random.default_rng(seed)
    nodes = rng.choice(topo.n, size=min(int(n_crash), topo.n), replace=False)
    crash = np.full(topo.n, NO_TICK, np.int32)
    restart = np.full(topo.n, NO_TICK, np.int32)
    crash[nodes] = at
    if heal is not None:
        restart[nodes] = heal
    return chaos.validate_plan(_crash_legs(crash, restart, device))


# -- canonical scenarios (the simbench/smoke/twin contract) -------------------


def topo_scenario_plan(
    name: str, n: int, seed: int = 0, horizon: int = 256,
    topo: Optional[Topology] = None, device: DeviceLike = None,
) -> FaultPlan:
    """The canonical topology scenarios, parameterized only by (name, n,
    seed, horizon) — same contract as ``chaos.scenario_plan``, so the
    bench, the smoke runs and the tests all construct the identical plan.  All ride the
    ``default_topology(n)`` tree (or ``topo``) WITH its tier legs:

    * ``zone_loss``   — zone 1 dark from horizon/32 to horizon/2;
    * ``switch_flap`` — rack 2's uplink flapping as one unit;
    * ``wan``         — one-way region partition window plus a tiny
      permanent crash cohort that must be detected THROUGH it;
    * ``independent`` — the control: as many scattered crashes as
      ``zone_loss`` takes down, same schedule;
    * ``flat``        — ``zone_loss`` WITHOUT tier penalties (a
      zero-penalty tree compiles to no tier legs at all): the
      constant-topology twin of the flat chaos step;
    * ``smoke``       — zone loss + a rack flap + the tier legs: every
      leg family in one tiny plan.
    """
    topo = topo if topo is not None else default_topology(n)
    dev = resolve_device(device)
    first = max(4, horizon // 32)
    heal = horizon // 2
    if name == "zone_loss":
        return chaos._merge_plans(
            zone_loss_plan(topo, zone=1, at=first, heal=heal, device=dev),
            topo.plan_legs(device=dev),
        )
    if name == "switch_flap":
        return chaos._merge_plans(
            switch_flap_plan(
                topo, rack=2 % topo.spec.total_racks,
                period=max(12, horizon // 10), down=max(3, horizon // 40),
                start=first, device=dev,
            ),
            topo.plan_legs(device=dev),
        )
    if name == "wan":
        return chaos._merge_plans(
            partition_plan(
                topo, level="region", cut=(topo.spec.regions - 1,),
                split_at=first, heal_at=heal, one_way=True, device=dev,
            ),
            chaos.churn_plan(
                n, n_churn=max(2, n // 1000), n_permanent=max(2, n // 1000),
                first=2, stagger=1, waves=1, seed=seed, device=dev,
            ),
            topo.plan_legs(device=dev),
        )
    if name == "independent":
        return chaos._merge_plans(
            independent_crash_plan(
                topo, int(topo.nodes_in_zone(1).size), at=first, heal=heal,
                seed=seed, device=dev,
            ),
            topo.plan_legs(device=dev),
        )
    if name == "flat":
        flat_topo = compile_topology(
            TopologySpec(
                regions=topo.spec.regions,
                zones_per_region=topo.spec.zones_per_region,
                racks_per_zone=topo.spec.racks_per_zone,
            ),
            n,
        )
        return chaos._merge_plans(
            zone_loss_plan(flat_topo, zone=1, at=first, heal=heal, device=dev),
            flat_topo.plan_legs(device=dev),  # penalty-free: the EMPTY plan
        )
    if name == "smoke":
        return chaos._merge_plans(
            zone_loss_plan(topo, zone=0, at=first, heal=heal, device=dev),
            switch_flap_plan(
                topo, rack=topo.spec.total_racks - 1, period=12, down=3,
                start=first + 2, device=dev,
            ),
            topo.plan_legs(device=dev),
        )
    raise ValueError(f"unknown topology scenario {name!r}")


def topo_scenario_specs(topo: Topology, seed: int = 0, horizon: int = 256,
                        reps: int = 1, device: DeviceLike = None) -> tuple[list[FaultPlan], list[dict]]:
    """The correlated-failure scenario FAMILY as (plans, meta) ready for
    ``chaos.stack_plans`` + ``scenarios.scored_fleet``: one zone-loss
    member per zone, one switch-flap per rack, symmetric + one-way WAN
    partitions, and one independent-crash control per zone (matched
    cohort size), each repeated ``reps`` times with distinct seeds.
    ``meta[i]`` carries ``event``/``locus``/``rep`` next to the
    ``scenario_id`` the fleet stamps."""
    dev = resolve_device(device)
    first = max(4, horizon // 32)
    heal = horizon // 2
    legs = topo.plan_legs(device=dev)
    has_legs = any(v is not None for v in legs)
    plans: list[FaultPlan] = []
    meta: list[dict] = []

    def add(event: str, locus: int, rep: int, plan: FaultPlan):
        plans.append(chaos._merge_plans(plan, legs) if has_legs else plan)
        meta.append(
            {"scenario_id": len(meta), "event": event, "locus": locus, "rep": rep}
        )

    for rep in range(reps):
        for z in range(topo.spec.total_zones):
            add("zone_loss", z, rep, zone_loss_plan(topo, z, at=first, heal=heal, device=dev))
        for r in range(topo.spec.total_racks):
            add(
                "switch_flap", r, rep,
                switch_flap_plan(
                    topo, r, period=max(12, horizon // 10),
                    down=max(3, horizon // 40), start=first + rep, device=dev,
                ),
            )
        for one_way in (False, True):
            add(
                "wan_oneway" if one_way else "wan",
                topo.spec.regions - 1, rep,
                partition_plan(
                    topo, level="region", cut=(topo.spec.regions - 1,),
                    split_at=first, heal_at=heal, one_way=one_way, device=dev,
                ),
            )
        for z in range(topo.spec.total_zones):
            add(
                "independent", z, rep,
                independent_crash_plan(
                    topo, int(topo.nodes_in_zone(z).size), at=first, heal=heal,
                    seed=seed + rep * 1000 + z, device=dev,
                ),
            )
    return plans, meta


# -- stats bridge -------------------------------------------------------------

TOPO_STAT_PREFIX = "ringpop.sim.topo"


def emit_topo_stats(reporter, score: dict, prefix: str = TOPO_STAT_PREFIX) -> None:
    """Feed a topology verdict's per-tier breakdowns into a host-plane
    ``StatsReporter`` under ``ringpop.sim.topo.*`` (the per-BLOCK keys
    ride the normal ``telemetry.emit_stats`` bridge; this is the
    score-record summary).  Null tiers (no suspicion flow observed) are
    skipped, not zeroed — same convention as ``chaos.emit_score_stats``."""
    for record_key, stat_key in (
        ("suspects_by_tier", "suspects"),
        ("false_positive_by_tier", "false-positives"),
        ("time_to_detect_by_tier", "time-to-detect"),
    ):
        per_tier = score.get(record_key)
        if not per_tier:
            continue
        for tier_name in TIER_NAMES:
            value = per_tier.get(tier_name.replace("-", "_"))
            if value is None:
                continue
            reporter.gauge(f"{prefix}.{stat_key}.{tier_name}", float(value))
    for key, suffix in (
        ("refutations_unreachable_dir", "refuted.unreachable-dir"),
        ("refutations_reachable_dir", "refuted.reachable-dir"),
    ):
        if score.get(key) is not None:
            reporter.gauge(f"{prefix}.{suffix}", float(score[key]))
