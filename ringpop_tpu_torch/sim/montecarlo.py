"""Monte-Carlo protocol studies: B whole simulated clusters stepped in
lockstep over a replica axis.

Counterpart of ``ringpop_tpu/sim/montecarlo.py``, bit for bit: replica b of
``MonteCarlo`` with ``seeds[b] == s`` produces tick for tick the state
``LifecycleSim(seed=s)`` produces, under its own slice of a batched fault
model, and ``fetch_telemetry`` gives the JAX fleet's per-scenario block
records.

The JAX fleet is ``jax.vmap`` of ``step``, ``detection_complete``,
``telemetry.fetch`` and ``tree_digest``.  ``torch.vmap`` cannot trace the
port's kernels (ctypes launches), so here each replica is stepped through
the port's solo :func:`lifecycle.step` with its own faults
(:func:`_index_faults`) and its own telemetry accumulator: every kernel of
the solo tick launches once a replica (L2, S1 and T1 each tick, P1 with
telemetry, L1 in each detection check, D1 and R1 in each fetch).
``MonteCarlo.states`` and ``.telemetry`` still read as batched
``LifecycleState`` / ``TelemetryState`` (every leaf with a leading B, leaf
for leaf the JAX fleet's), stacked on read, and take the batched form when
set.  The detection loop keeps the JAX loop's lockstep and its one host
sync a block for all B flags.

The fault model is a batchable axis: ``faults`` may carry a leading
replica axis on any ``DeltaFaults`` leaf (decided by rank,
``_DELTA_FAULTS_NDIM``), or be a STACKED ``chaos.FaultPlan``
(``chaos.stack_plans``).  ``sim/scenarios.py`` builds parameter-grid
sweeps on top of this.

On a mesh (``mesh=``): a ``make_fleet_mesh`` mesh (``"batch"``, ``"node"``,
``"rumor"``) gives batch coordinate b the replicas
``partition.process_block(B, b, Bm)``, each stepped through the sharded
solo ``step`` over b's (P, R) mesh with the rank's rows and word block; a
rank holds only its replicas' blocks, and replica ``lo + i`` reads
scenario ``lo + i``'s faults.  Scenarios are independent, so the batch
axis carries no collective inside a tick: only the detection loop's flags
(one gather a block, so every batch group steps until every replica has
detected, as the unsharded loop does), ``fetch_telemetry``'s records and
digests (gathered in scenario order, every rank the same list) and the
whole-fleet reads of ``states`` and ``telemetry``.  A (P, R) mesh with no
batch axis keeps the JAX package's other layout: every rank holds every
replica, each sharded.

Not ported yet, refused with NotImplementedError: the AOT warm start
(``aot=``: A15).

Reference analogs: failure detection `swim/node.go:470-513`; the suspicion
timeout sweep scenario (BASELINE `sweep100k`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.sim import chaos, prng
from ringpop_tpu_torch.sim import telemetry as _tm
from ringpop_tpu_torch.sim.delta import DeltaFaults
from ringpop_tpu_torch.sim.lifecycle import (
    FAULTY,
    LifecycleParams,
    LifecycleState,
    _check_supported,
    _subjects,
    detection_complete,
    detection_fraction,
    init_state_from_key,
    step,
)

_AOT_REFUSAL = "the AOT warm start (util/aot) is not ported yet (ROADMAP Queue A15)"


def _stack(trees: list):
    """B solo NamedTuples -> one whose leaves carry a leading B (None legs
    stay None)."""
    first = trees[0]
    return type(first)(*(
        None if leaf is None else torch.stack([t[i] for t in trees])
        for i, leaf in enumerate(first)))


def _unstack(tree) -> list:
    """A batched NamedTuple -> B solo ones, each leaf a copy: the telemetry
    accumulators are updated in place, which must not write into the
    caller's tensors."""
    b = next(int(x.shape[0]) for x in tree if x is not None)
    return [type(tree)(*(None if x is None else x[i].clone() for x in tree)) for i in range(b)]


def init_replicas(params: LifecycleParams, seeds: Sequence[int], mesh=None,
                  device: DeviceLike = None) -> LifecycleState:
    """Batched state: every leaf gains a leading replica axis B, on
    ``device`` (the card unless the caller asks for the CPU; the mesh's
    device on a mesh).  Replica b's key is ``prng.prng_key(seeds[b])``, the
    value ``jax.random.PRNGKey`` gives for any seed Python accepts (seeds >=
    2**32 and negative seeds included), so its stream is exactly
    ``LifecycleSim(seed=...)``'s.  On a ``mesh``, this rank's block: its
    replicas (its batch block of B) with its rows and word block of each."""
    layout = _Layout(params, len(seeds), mesh, device)
    return _stack(_init_solo(layout.params, list(seeds)[layout.lo:layout.hi], layout.device))


def _init_solo(params: LifecycleParams, seeds: Sequence[int], device: torch.device) -> list:
    return [init_state_from_key(params, prng.prng_key(s, device), device) for s in seeds]


def make_fleet_mesh(n_devices: Optional[int] = None, shape=None, transport: Optional[str] = None, device=None):
    """The ``("batch", "node", "rumor")`` mesh for block-sharded fleets over
    the job's ``torch.distributed`` ranks (``parallel.mesh.FleetMesh``):
    rank ``b·P·R + p·R + r`` at (b, p, r).  ``n_devices`` (default: every
    rank of the job) must be the job's size; ``shape`` defaults to
    ``(n, 1, 1)``, all parallelism on the batch axis (scenarios are
    independent, so it adds no collective inside a tick and divides each
    rank's residency by the batch factor).  A collective: every rank makes
    the mesh's subgroups in one order.  Ranks are processes here, so there
    is no falling back to other devices: a job of another size raises."""
    from ringpop_tpu_torch.parallel import mesh as pmesh, multihost

    size = multihost.process_count()
    n = size if n_devices is None else int(n_devices)
    if n != size:
        raise ValueError(f"need {n} ranks, the job has {size} (one process a rank: multihost.init_distributed)")
    return pmesh.make_fleet_mesh(shape=(n, 1, 1) if shape is None else tuple(shape), transport=transport,
                                 device=device)


def fleet_save_mesh(transport: Optional[str] = None, device=None):
    """The one-axis fleet mesh over every process of the job in process
    order, ``(nprocs, 1, 1)``: the checkpoint placement mesh for
    process-sliced sweeps (``partition.fleet_shard_put`` places each
    process's batch slice on it, so the store holds every process's rows,
    each written by its process).  It makes no subgroup (the batch axis is
    the job's default group), so it is no collective.  Single-process it is
    the one-rank mesh: the same code path."""
    from ringpop_tpu_torch.parallel import mesh as pmesh, multihost

    return pmesh.make_fleet_mesh(shape=(multihost.process_count(), 1, 1), transport=transport, device=device)


def fleet_state_shardings(mesh, k=None):
    """A ``LifecycleState`` of ``partition.NamedSharding`` for a [B, ...]
    replica batch on ``mesh``, from the canonical rule table with a
    one-deep batch prefix: on a fleet mesh the replica axis is sharded over
    ``"batch"`` and every state axis keeps its place; on a (P, R) mesh the
    batch is replicated and every replica sharded.  ``k`` is checked against
    the mesh's rumor axis (``packbits.check_rumor_shardable``)."""
    from ringpop_tpu_torch.sim.packbits import check_rumor_shardable

    if k is not None:
        check_rumor_shardable(k, mesh.shape.get("rumor", 1))
    return fleet_shardings(LifecycleState(**{f: 0 for f in LifecycleState._fields}), mesh)


def fleet_shardings(tree, mesh):
    """``partition.NamedSharding`` for every leaf of any [B, ...]-batched
    fleet tree (accumulators, a checkpoint carry), by the rule of
    :func:`fleet_state_shardings`."""
    from ringpop_tpu_torch.parallel.partition import named_shardings

    return named_shardings(tree, mesh, batch_axes=1, batch_axis="batch" if "batch" in mesh.shape else None)


def fleet_faults_shardings(faults, mesh):
    """Per-leg ``partition.NamedSharding`` of a (possibly) batched fault
    model on a fleet mesh: stacked legs (one more axis than their solo rank)
    take the batch prefix, over ``"batch"`` where the mesh has it; shared
    legs keep their canonical spec; None legs stay None."""
    from ringpop_tpu_torch.parallel.partition import P, NamedSharding, spec_for

    batch = "batch" if "batch" in mesh.shape else None
    if isinstance(faults, chaos.FaultPlan):
        stacked = {f: v is not None and chaos._leg_rank(f, v) == 1 for f, v in zip(faults._fields, faults)}
        fields, cls = faults._fields, chaos.FaultPlan
    else:
        stacked = {f: _batched(f, getattr(faults, f)) for f in _DELTA_FAULTS_NDIM}
        fields, cls = tuple(_DELTA_FAULTS_NDIM), DeltaFaults
    out = {}
    for f in fields:
        if getattr(faults, f) is None:
            continue
        spec = spec_for(f)
        out[f] = NamedSharding(mesh, P(batch, *spec) if stacked[f] else spec)
    return cls(**out)


class _Layout:
    """Where a fleet of ``b`` replicas lives on ``mesh``: the params its
    replicas step with (bound to the inner (P, R) mesh), this rank's
    replicas [lo, hi), the inner mesh (None when unsharded) and the batch
    axis (a ``Mesh`` of the batch coordinates, None without one)."""

    def __init__(self, params: LifecycleParams, b: int, mesh, device: DeviceLike):
        from ringpop_tpu_torch.parallel.mesh import FleetMesh, with_exchange_mesh

        self.batch = mesh.batch if isinstance(mesh, FleetMesh) else None
        inner = mesh.inner if isinstance(mesh, FleetMesh) else mesh
        self.inner = inner if inner is not None and inner.sharded else None
        self.params = with_exchange_mesh(params, self.inner) if self.inner is not None else params
        self.lo, self.hi = self.batch.block(b) if self.batch is not None else (0, b)
        self.device = resolve_device(device if device is not None or mesh is None else mesh.device)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's replicas' [B_local, ...] rows -> the whole fleet's."""
        return t if self.batch is None else self.batch.gather_rows(t)


# solo (unbatched) ndim per DeltaFaults leaf — a leaf with one more axis
# carries a leading replica axis (chaos.PLAN_LEG_NDIM is the FaultPlan analog)
_DELTA_FAULTS_NDIM = {
    "up": 1,
    "group": 1,
    "drop_rate": 0,
    "drop_node": 1,
    "reach": 2,
    "tier_ids": 2,
    "tier_drop": 1,
    "suspect_ticks": 0,
}


def _batched(field: str, x) -> bool:
    return x is not None and getattr(x, "ndim", 0) == _DELTA_FAULTS_NDIM[field] + 1


def _faults_axes(faults):
    """Which legs of the fault model carry the replica axis (the JAX
    package's vmap ``in_axes``): 0 for a batched leg, None for a shared or
    absent one — or None when nothing is batched.  A ``DeltaFaults`` leg
    is batched when it has one more axis than its solo rank; a stacked
    ``chaos.FaultPlan`` answers through ``chaos.plan_axes``."""
    if isinstance(faults, chaos.FaultPlan):
        return chaos.plan_axes(faults)
    axes = {f: (0 if _batched(f, getattr(faults, f)) else None) for f in _DELTA_FAULTS_NDIM}
    if all(v is None for v in axes.values()):
        return None
    return DeltaFaults(**axes)


def _index_faults(faults, b: int):
    """Replica ``b``'s solo fault model out of a (possibly) batched one —
    batched leaves are sliced, shared leaves pass through (the DeltaFaults
    analog of ``chaos.index_plan``)."""
    if isinstance(faults, chaos.FaultPlan):
        return chaos.index_plan(faults, b)
    return DeltaFaults(**{
        f: (getattr(faults, f)[b] if _batched(f, getattr(faults, f)) else getattr(faults, f))
        for f in _DELTA_FAULTS_NDIM
    })


def _replica_faults(faults, lo: int, hi: int) -> list:
    """The solo fault models of replicas [lo, hi) (:func:`_index_faults`, by
    global scenario id)."""
    return [_index_faults(faults, b) for b in range(lo, hi)]


def _mc_block(params: LifecycleParams, states: list, faults: list, ticks: int, telemetry=None):
    """``ticks`` steps of every replica: replica b steps through the solo
    ``lifecycle.step`` under ``faults[b]``.  ``telemetry`` (a list of B
    accumulators, or None): when given each replica's counters accumulate
    in place and the pair (states, telemetry) is returned; the None leg is
    the telemetry-free tick."""
    states = list(states)
    for b in range(len(states)):
        s = states[b]
        if telemetry is None:
            for _ in range(ticks):
                s = step(params, s, faults[b])
        else:
            for _ in range(ticks):
                s, _ = step(params, s, faults[b], telemetry[b])
        states[b] = s
    return states if telemetry is None else (states, telemetry)


def _mc_fetch(tel: list, states: list, faults: list, layout: Optional[_Layout] = None):
    """The fleet's telemetry fetch: every replica's solo ``telemetry.fetch``
    (R1 once a replica on the card) and state digest (D1 once a replica),
    the records stacked into one [B]-column record; on a mesh each over the
    replica's (P, R) mesh, and the columns gathered over the batch axis in
    scenario order.  Returns (record, fresh accumulators, digests[B])."""
    inner = None if layout is None else layout.inner
    records, fresh = [], []
    for t, s, f in zip(tel, states, faults):
        rec, zero = _tm.fetch(t, s, f, inner)
        records.append(rec)
        fresh.append(zero)
    record = {k: torch.stack([r[k] for r in records]) for k in records[0]}
    digests = torch.stack([_tm.tree_digest(s, inner) for s in states])
    if layout is not None and layout.batch is not None:
        columns = _gather_columns(layout, {**record, "state_digest": digests})
        digests = columns.pop("state_digest")
        record = columns
    return record, fresh, digests


def _gather_columns(layout: _Layout, columns: dict) -> dict:
    """[B_local] columns of mixed dtypes -> the whole fleet's [B] columns,
    in one gather over the batch axis: each column crosses as its bits in
    an int64 lane."""
    lanes = []
    for v in columns.values():
        if v.is_floating_point():
            v = v.view(torch.int32 if v.element_size() == 4 else torch.int64)
        lanes.append(v.to(torch.int64))
    whole = layout.gather(torch.stack(lanes, dim=1))
    out = {}
    for i, (key, v) in enumerate(columns.items()):
        lane = whole[:, i]
        if v.is_floating_point():
            lane = lane.to(torch.int32 if v.element_size() == 4 else torch.int64).view(v.dtype)
        out[key] = lane.to(v.dtype)
    return out


def _detected(states: list, subjects: torch.Tensor, faults: list, min_status: int,
              layout: Optional[_Layout] = None) -> np.ndarray:
    """bool[B]: ``detection_complete`` of every replica of the fleet (L1
    once a replica on the card; on a mesh each over its (P, R) mesh, then
    the flags gathered over the batch axis), brought over in ONE host
    sync."""
    inner = None if layout is None else layout.inner
    flags = torch.stack([detection_complete(s, subjects, f, min_status, mesh=inner) for s, f in zip(states, faults)])
    if layout is not None:
        flags = layout.gather(flags)
    return flags.cpu().numpy()


def _mc_run_until_device(params: LifecycleParams, states: list, faults: list, subjects: torch.Tensor,
                         telemetry=None, *, min_status: int, block_ticks: int, max_blocks: int,
                         layout: Optional[_Layout] = None):
    """The whole detection study: step every replica in lockstep blocks of
    ``block_ticks`` ticks, test each with ``detection_complete`` after
    every block (one host sync a block for all B flags), record each
    replica's first detected block, stop when every replica has detected or
    ``max_blocks`` blocks have run.  A replica that finished keeps stepping
    (its recorded block is frozen), and an armed ``telemetry`` (a list of B
    accumulators) rides every stepped tick.  The entry check reports block
    0 for a state that has already detected.  On a mesh (``layout``) every
    rank reads every replica's flag (:func:`_detected`), so a batch group
    whose own replicas are done steps on until the whole fleet is, as the
    unsharded loop does.

    Returns (states, telemetry, blocks_run, first_block[B] (-1 = never))."""
    first = np.where(_detected(states, subjects, faults, min_status, layout), 0, -1).astype(np.int32)
    blocks = 0
    while (first < 0).any() and blocks < max_blocks:
        if telemetry is None:
            states = _mc_block(params, states, faults, block_ticks)
        else:
            states, telemetry = _mc_block(params, states, faults, block_ticks, telemetry)
        blocks += 1
        first = np.where((first < 0) & _detected(states, subjects, faults, min_status, layout), blocks, first)
    return states, telemetry, blocks, first


class MonteCarlo:
    """B lockstep cluster replicas differing in PRNG seed AND (optionally)
    fault scenario, on ``device`` (the card unless the caller asks for the
    CPU): ``faults`` may be a ``DeltaFaults`` with [B, ...] leaves or a
    STACKED ``chaos.FaultPlan`` (``chaos.stack_plans``).

    ``telemetry=True`` carries one counter accumulator a replica through
    every :meth:`run` tick AND every tick :meth:`run_until_detected` steps;
    :meth:`fetch_telemetry` reduces them to B per-scenario block records
    (tagged ``scenario_id``) — the journal ``chaos.score_blocks`` reduces
    into per-scenario verdicts.  ``telemetry_tiers`` arms the per-tier
    suspicion counters.

    ``mesh``: a ``make_fleet_mesh`` mesh block-shards the fleet (this rank
    holds its batch block of the replicas, each over its batch group's (P,
    R) mesh, with the whole plan's legs read by global scenario id); a (P,
    R) ``parallel.mesh.Mesh`` shards every replica and replicates the
    batch.  Every member stays bit-identical to its unsharded twin, and
    ``states``/``telemetry`` read as the whole fleet (gathered).  ``aot``
    is refused (A15), where ``aot_info`` stays ``{}``.

    >>> mc = MonteCarlo(LifecycleParams(n=512, k=32), seeds=range(32))
    >>> ticks, detected = mc.run_until_detected(victims=[3, 99], faults=f)
    >>> np.median(ticks[detected])   # detection-latency distribution
    """

    def __init__(
        self,
        params: LifecycleParams,
        seeds: Sequence[int],
        telemetry: bool = False,
        aot: Optional[str] = None,
        telemetry_tiers: bool = False,
        mesh=None,
        device: DeviceLike = None,
    ):
        if aot is not None:
            raise NotImplementedError(_AOT_REFUSAL)
        self.params = params
        self.seeds = list(seeds)
        self.mesh = mesh
        self._layout = _Layout(params, len(self.seeds), mesh, device)
        _check_supported(self._layout.params)
        self.device = self._layout.device
        self.aot_info: dict = {}
        self._telemetry_tiers = telemetry_tiers
        self._states = self._fresh_states()
        self._tel = self._fresh_telemetry() if telemetry else None

    def _fresh_states(self) -> list:
        lay = self._layout
        return _init_solo(lay.params, self.seeds[lay.lo:lay.hi], self.device)

    def _fresh_telemetry(self) -> list:
        return [_tm.zeros(self._layout.params, tiers=self._telemetry_tiers, device=self.device)
                for _ in self._states]

    def _whole(self, solo: list):
        """The whole fleet of a tree from this rank's replicas' blocks:
        each gathered over its (P, R) mesh, stacked, then gathered over the
        batch axis.  Without a mesh, the stack."""
        lay = self._layout
        if self.mesh is None:
            return _stack(solo)
        if lay.inner is not None:
            from ringpop_tpu_torch.parallel.partition import host_gather

            solo = [type(s)(*(None if x is None else torch.from_numpy(x).to(self.device)
                              for x in host_gather(s, lay.inner))) for s in solo]
        return type(solo[0])(*(None if leaf is None else lay.gather(leaf) for leaf in _stack(solo)))

    def _solo(self, batched) -> list:
        """Solo trees on this fleet's device from a [b, ...] tree (tensors or
        numpy), each leaf a copy."""
        return _unstack(type(batched)(*(None if x is None else torch.as_tensor(x).to(self.device) for x in batched)))

    def _local(self, batched) -> list:
        """This rank's replicas' solo blocks of a whole batched tree."""
        lay = self._layout
        solo = self._solo(type(batched)(*(None if x is None else x[lay.lo:lay.hi] for x in batched)))
        if lay.inner is None:
            return solo
        from ringpop_tpu_torch.parallel.partition import shard_put

        return [shard_put(t, lay.inner, self.params.n) for t in solo]

    @property
    def states(self) -> LifecycleState:
        """The batched state: every leaf [B, ...] (the whole fleet, gathered
        from the ranks on a mesh; a collective there)."""
        return self._whole(self._states)

    @states.setter
    def states(self, batched: LifecycleState) -> None:
        if int(batched.tick.shape[0]) != self.n_replicas:
            raise ValueError(f"a B={int(batched.tick.shape[0])} state for a B={self.n_replicas} fleet")
        self._states = self._local(batched)

    @property
    def telemetry(self) -> Optional[_tm.TelemetryState]:
        """The batched accumulators (every leaf [B, ...], the whole fleet's),
        or None when telemetry is off."""
        return None if self._tel is None else self._whole(self._tel)

    @telemetry.setter
    def telemetry(self, batched: Optional[_tm.TelemetryState]) -> None:
        self._tel = None if batched is None else self._local(batched)

    def local_blocks(self):
        """(states, telemetry) of this rank's replicas as host numpy,
        [B_local, ...] blocks of the port's dtypes (telemetry None when off),
        copied replica by replica so the card holds no second copy of the
        fleet."""
        def host(solo: list):
            return type(solo[0])(*(None if leaf is None else np.stack([t[i].detach().cpu().numpy() for t in solo])
                                   for i, leaf in enumerate(solo[0])))

        return host(self._states), None if self._tel is None else host(self._tel)

    def set_local_blocks(self, states, telemetry=None) -> None:
        """Take this rank's replicas' blocks ([B_local, ...] leaves, as
        :meth:`local_blocks` gives them or a restore reads them)."""
        solo = self._solo(states)
        if len(solo) != len(self._states):
            raise ValueError(f"{len(solo)} replicas for this rank's {len(self._states)}")
        self._states = solo
        self._tel = None if telemetry is None else self._solo(telemetry)

    def whole_spec(self, b: int) -> dict:
        """{"states", "telemetry"} of a [b, ...] fleet of this config as
        ``meta`` tensors: the whole solo shapes (a replica's blocks widened
        over its (P, R) mesh) with a leading b, the port's dtypes; telemetry
        None when off.  A checkpoint restore's target."""
        from ringpop_tpu_torch.parallel.partition import _tree_map_named, global_shape_of, spec_for

        inner = self._layout.inner

        def spec(name, leaf):
            shape = tuple(leaf.shape) if inner is None else global_shape_of(spec_for(name), inner, tuple(leaf.shape))
            return torch.empty((b,) + shape, dtype=leaf.dtype, device="meta")

        return _tree_map_named(spec, {"states": self._states[0], "telemetry": None if self._tel is None else self._tel[0]})

    @property
    def block(self) -> tuple[int, int]:
        """This rank's replicas [lo, hi) of the fleet."""
        return self._layout.lo, self._layout.hi

    def reset_states(self, seeds: Optional[Sequence[int]] = None):
        """Re-seed the fleet in place (same B).  Zeroes the telemetry
        accumulators when armed."""
        if seeds is not None:
            seeds = list(seeds)
            if len(seeds) != len(self.seeds):
                raise ValueError(
                    f"reset_states got {len(seeds)} seeds for a B="
                    f"{len(self.seeds)} fleet (B is fixed for the fleet)"
                )
            self.seeds = seeds
        self._states = self._fresh_states()
        if self._tel is not None:
            self._tel = self._fresh_telemetry()

    def detection_fractions(
        self, subjects, faults: DeltaFaults = DeltaFaults(), min_status: int = FAULTY
    ) -> np.ndarray:
        """Detection fractions per replica -> float[B, S], a host loop over
        replicas (``lifecycle.detection_fraction`` each, on the whole fleet
        on a mesh)."""
        states = self._states if self.mesh is None else _unstack(self.states)
        rows = []
        for b, state in enumerate(states):
            rows.append(detection_fraction(state, subjects, _index_faults(faults, b), min_status).cpu().numpy())
        return np.stack(rows)

    @property
    def n_replicas(self) -> int:
        return len(self.seeds)

    def _faults(self, faults) -> list:
        return _replica_faults(faults, self._layout.lo, self._layout.hi)

    def run(self, ticks: int, faults: DeltaFaults = DeltaFaults()) -> LifecycleState:
        """``ticks`` steps of every replica; returns the batched state (a
        stacked copy; on a mesh the whole fleet, gathered)."""
        self.advance(ticks, faults)
        return self.states

    def advance(self, ticks: int, faults: DeltaFaults = DeltaFaults()) -> None:
        """``ticks`` steps of every replica of this rank, reading nothing
        back: :meth:`run` without the batched copy."""
        params, per = self._layout.params, self._faults(faults)
        if self._tel is None:
            self._states = _mc_block(params, self._states, per, ticks)
        else:
            self._states, self._tel = _mc_block(params, self._states, per, ticks, self._tel)

    def fetch_telemetry(self, faults: DeltaFaults = DeltaFaults(), id_base: int = 0) -> list[dict]:
        """Fetch-and-reset the accumulators: B per-scenario host block
        records (``scenario_id`` = ``id_base`` + replica index), each with
        its replica's ``state_digest``; on a mesh every rank gets every
        record, in scenario order."""
        if self._tel is None:
            raise ValueError("MonteCarlo built without telemetry=True")
        record, self._tel, digests = _mc_fetch(self._tel, self._states, self._faults(faults), self._layout)
        return _tm.split_batched(record, {"state_digest": digests}, id_base=id_base)

    def digests(self) -> list[int]:
        """Every replica's state digest, in replica order (D1 once a replica
        on the card; on a mesh each over its (P, R) mesh, then gathered)."""
        lay = self._layout
        local = torch.stack([_tm.tree_digest(s, lay.inner) for s in self._states])
        return [int(x) for x in lay.gather(local).cpu()]

    def run_until_detected(
        self,
        victims: Sequence[int],
        faults: DeltaFaults = DeltaFaults(),
        min_status: int = FAULTY,
        max_ticks: int = 2048,
        check_every: int = 8,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Advance all replicas in lockstep until each has every live
        observer believing every victim >= ``min_status``.

        Returns ``(first_detected_tick[B], detected[B])`` — the tick count
        (a multiple of ``check_every``, like ``LifecycleSim``'s) at which
        each replica first measured full detection, -1 if it did not within
        ``max_ticks`` (``ceil(max_ticks / check_every)`` blocks).  Replicas
        that finish early keep stepping; their recorded tick is frozen.  An
        armed telemetry accumulator covers every tick the fleet stepped."""
        subjects = _subjects(list(victims), self.device)
        max_blocks = -(-max_ticks // check_every)
        self._states, self._tel, _, first_block = _mc_run_until_device(
            self._layout.params, self._states, self._faults(faults), subjects, self._tel, min_status=min_status,
            block_ticks=check_every, max_blocks=max_blocks, layout=self._layout,
        )
        first_block = np.asarray(first_block, np.int64)
        first_tick = np.where(first_block >= 0, first_block * check_every, -1)
        detected = first_tick >= 0
        return first_tick, detected


def detection_latency_distribution(
    n: int,
    seeds: Sequence[int],
    victims: Sequence[int],
    k: int = 32,
    suspect_ticks: Optional[int] = None,
    max_ticks: int = 2048,
    check_every: int = 1,
    device: DeviceLike = None,
) -> dict:
    """One-call study: crash ``victims`` in B seeded replicas of an n-node
    cluster and return the detection-latency distribution (in ticks and in
    simulated seconds at the 200 ms protocol period), checked every
    ``check_every`` ticks (1: each replica's exact first-detection tick).
    Reference discipline analog: percentile-grade timing stats,
    ``swim/stats.go:81-104``."""
    kw = {} if suspect_ticks is None else {"suspect_ticks": suspect_ticks}
    params = LifecycleParams(n=n, k=k, **kw)
    dev = resolve_device(device)
    tick_s = params.tick_ms / 1000.0
    up = np.ones(n, bool)
    up[np.asarray(list(victims), np.int64)] = False
    faults = DeltaFaults(up=torch.as_tensor(up, device=dev))
    mc = MonteCarlo(params, seeds, device=dev)
    ticks, detected = mc.run_until_detected(victims, faults, max_ticks=max_ticks, check_every=check_every)
    return _distribution(ticks, detected, mc.n_replicas, tick_s)


def _distribution(ticks: np.ndarray, detected: np.ndarray, n_replicas: int, tick_s: float) -> dict:
    det = ticks[detected].astype(float)
    return {
        "n_replicas": n_replicas,
        "detected": int(detected.sum()),
        "ticks_median": float(np.median(det)) if det.size else None,
        "ticks_p90": float(np.percentile(det, 90)) if det.size else None,
        "ticks_max": float(det.max()) if det.size else None,
        "sim_s_median": float(np.median(det) * tick_s) if det.size else None,
        # exact per-replica first-detection ticks (sorted)
        "ticks_all": sorted(int(t) for t in det),
    }


def detection_latency_under_churn(
    n: int,
    seeds: Sequence[int],
    victims: Sequence[int],
    churn_max: int,
    k: int = 32,
    suspect_ticks: Optional[int] = None,
    max_p: Optional[int] = None,
    max_ticks: int = 2048,
    check_every: int = 1,
    churn_seed: int = 1234,
    device: DeviceLike = None,
) -> dict:
    """Heterogeneous-scenario study: how long until the SAME victim set is
    detected, as a function of how much other churn the cluster is
    digesting?  Replica b shares the study victims and additionally crashes
    ``round(b/(B-1) * churn_max)`` background nodes (a per-replica ``up``
    mask, ``scenarios.churn_dose_masks``).  Detection is judged only on the
    shared victims.  Returns the distribution plus ``churn_counts`` and the
    dose-response curve ``churn_ticks`` ([churn, first tick or None] in
    replica order)."""
    kw = {} if suspect_ticks is None else {"suspect_ticks": suspect_ticks}
    if max_p is not None:
        kw["max_p"] = max_p
    params = LifecycleParams(n=n, k=k, **kw)
    dev = resolve_device(device)
    tick_s = params.tick_ms / 1000.0
    seeds = list(seeds)
    victims = sorted(int(v) for v in victims)

    from ringpop_tpu_torch.sim.scenarios import churn_dose_masks, mc_churn_doses

    churn_counts = mc_churn_doses(len(seeds), churn_max)
    up = churn_dose_masks(n, victims, churn_counts, churn_seed)
    faults = DeltaFaults(up=torch.as_tensor(up, device=dev))

    mc = MonteCarlo(params, seeds, device=dev)
    ticks, detected = mc.run_until_detected(victims, faults, max_ticks=max_ticks, check_every=check_every)
    out = _distribution(ticks, detected, mc.n_replicas, tick_s)
    out["churn_counts"] = churn_counts
    out["churn_ticks"] = [
        [int(c), int(t) if d else None]
        for c, t, d in zip(churn_counts, ticks, detected)
    ]
    return out
