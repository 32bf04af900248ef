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

Not ported yet, each refused with NotImplementedError: the fleet meshes and
shardings (``mesh=``, ``make_fleet_mesh``, ``fleet_save_mesh``,
``fleet_state_shardings``, ``fleet_shardings``,
``fleet_faults_shardings``: ROADMAP A12b) and the AOT warm start (``aot=``:
A15).

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

_MESH_REFUSAL = "the fleet meshes and shardings are not ported yet (ROADMAP A12b)"
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
    ``device`` (the card unless the caller asks for the CPU).  Replica b's
    key is ``prng.prng_key(seeds[b])``, the value ``jax.random.PRNGKey``
    gives for any seed Python accepts (seeds >= 2**32 and negative seeds
    included), so its stream is exactly ``LifecycleSim(seed=...)``'s.
    ``mesh`` is refused (ROADMAP A12b)."""
    return _stack(_init_solo(params, seeds, mesh, device))


def _init_solo(params: LifecycleParams, seeds: Sequence[int], mesh, device: DeviceLike) -> list:
    if mesh is not None:
        raise NotImplementedError(_MESH_REFUSAL)
    dev = resolve_device(device)
    return [init_state_from_key(params, prng.prng_key(s, dev), dev) for s in seeds]


def make_fleet_mesh(n_devices: Optional[int] = None, shape=None):
    """Refused: a block-sharded fleet mesh is ROADMAP A12b."""
    raise NotImplementedError(_MESH_REFUSAL)


def fleet_save_mesh():
    """Refused: the process-spanning checkpoint mesh is ROADMAP A12b."""
    raise NotImplementedError(_MESH_REFUSAL)


def fleet_state_shardings(mesh, k=None):
    """Refused: fleet shardings are ROADMAP A12b."""
    raise NotImplementedError(_MESH_REFUSAL)


def fleet_shardings(tree, mesh):
    """Refused: fleet shardings are ROADMAP A12b."""
    raise NotImplementedError(_MESH_REFUSAL)


def fleet_faults_shardings(faults, mesh):
    """Refused: fleet shardings are ROADMAP A12b."""
    raise NotImplementedError(_MESH_REFUSAL)


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


def _replica_faults(faults, b_count: int) -> list:
    """Every replica's solo fault model (:func:`_index_faults`)."""
    return [_index_faults(faults, b) for b in range(b_count)]


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


def _mc_fetch(tel: list, states: list, faults: list):
    """The fleet's telemetry fetch: every replica's solo ``telemetry.fetch``
    (R1 once a replica on the card) and state digest (D1 once a replica),
    the records stacked into one [B]-column record.  Returns (record,
    fresh accumulators, digests[B])."""
    records, fresh = [], []
    for t, s, f in zip(tel, states, faults):
        rec, zero = _tm.fetch(t, s, f)
        records.append(rec)
        fresh.append(zero)
    record = {k: torch.stack([r[k] for r in records]) for k in records[0]}
    digests = torch.stack([_tm.tree_digest(s) for s in states])
    return record, fresh, digests


def _detected(states: list, subjects: torch.Tensor, faults: list, min_status: int) -> np.ndarray:
    """bool[B]: ``detection_complete`` of every replica (L1 once a replica
    on the card), brought over in ONE host sync."""
    flags = torch.stack([detection_complete(s, subjects, f, min_status) for s, f in zip(states, faults)])
    return flags.cpu().numpy()


def _mc_run_until_device(params: LifecycleParams, states: list, faults: list, subjects: torch.Tensor,
                         telemetry=None, *, min_status: int, block_ticks: int, max_blocks: int):
    """The whole detection study: step every replica in lockstep blocks of
    ``block_ticks`` ticks, test each with ``detection_complete`` after
    every block (one host sync a block for all B flags), record each
    replica's first detected block, stop when every replica has detected or
    ``max_blocks`` blocks have run.  A replica that finished keeps stepping
    (its recorded block is frozen), and an armed ``telemetry`` (a list of B
    accumulators) rides every stepped tick.  The entry check reports block
    0 for a state that has already detected.

    Returns (states, telemetry, blocks_run, first_block[B] (-1 = never))."""
    first = np.where(_detected(states, subjects, faults, min_status), 0, -1).astype(np.int32)
    blocks = 0
    while (first < 0).any() and blocks < max_blocks:
        if telemetry is None:
            states = _mc_block(params, states, faults, block_ticks)
        else:
            states, telemetry = _mc_block(params, states, faults, block_ticks, telemetry)
        blocks += 1
        first = np.where((first < 0) & _detected(states, subjects, faults, min_status), blocks, first)
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

    ``mesh`` is refused (ROADMAP A12b) and ``aot`` is refused (A15), where
    ``aot_info`` stays ``{}``.

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
        if mesh is not None:
            raise NotImplementedError(_MESH_REFUSAL)
        _check_supported(params)
        self.params = params
        self.seeds = list(seeds)
        self.mesh = None
        self.device = resolve_device(device)
        self.aot_info: dict = {}
        self._telemetry_tiers = telemetry_tiers
        self._states = _init_solo(params, self.seeds, None, self.device)
        self._tel = self._fresh_telemetry() if telemetry else None

    def _fresh_telemetry(self) -> list:
        return [_tm.zeros(self.params, tiers=self._telemetry_tiers, device=self.device) for _ in self.seeds]

    @property
    def states(self) -> LifecycleState:
        """The batched state: every leaf [B, ...], stacked on read."""
        return _stack(self._states)

    @states.setter
    def states(self, batched: LifecycleState) -> None:
        solo = _unstack(batched)
        if len(solo) != self.n_replicas:
            raise ValueError(f"a B={len(solo)} state for a B={self.n_replicas} fleet")
        self._states = solo

    @property
    def telemetry(self) -> Optional[_tm.TelemetryState]:
        """The batched accumulators (every leaf [B, ...]), or None when
        telemetry is off."""
        return None if self._tel is None else _stack(self._tel)

    @telemetry.setter
    def telemetry(self, batched: Optional[_tm.TelemetryState]) -> None:
        self._tel = None if batched is None else _unstack(batched)

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
        self._states = _init_solo(self.params, self.seeds, None, self.device)
        if self._tel is not None:
            self._tel = self._fresh_telemetry()

    def detection_fractions(
        self, subjects, faults: DeltaFaults = DeltaFaults(), min_status: int = FAULTY
    ) -> np.ndarray:
        """Detection fractions per replica -> float[B, S], a host loop over
        replicas (``lifecycle.detection_fraction`` each)."""
        rows = []
        for b, state in enumerate(self._states):
            rows.append(detection_fraction(state, subjects, _index_faults(faults, b), min_status).cpu().numpy())
        return np.stack(rows)

    @property
    def n_replicas(self) -> int:
        return len(self.seeds)

    def run(self, ticks: int, faults: DeltaFaults = DeltaFaults()) -> LifecycleState:
        per = _replica_faults(faults, self.n_replicas)
        if self._tel is None:
            self._states = _mc_block(self.params, self._states, per, ticks)
        else:
            self._states, self._tel = _mc_block(self.params, self._states, per, ticks, self._tel)
        return self.states

    def fetch_telemetry(self, faults: DeltaFaults = DeltaFaults(), id_base: int = 0) -> list[dict]:
        """Fetch-and-reset the accumulators: B per-scenario host block
        records (``scenario_id`` = ``id_base`` + replica index), each with
        its replica's ``state_digest``."""
        if self._tel is None:
            raise ValueError("MonteCarlo built without telemetry=True")
        per = _replica_faults(faults, self.n_replicas)
        record, self._tel, digests = _mc_fetch(self._tel, self._states, per)
        return _tm.split_batched(record, {"state_digest": digests}, id_base=id_base)

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
        per = _replica_faults(faults, self.n_replicas)
        max_blocks = -(-max_ticks // check_every)
        self._states, self._tel, _, first_block = _mc_run_until_device(
            self.params, self._states, per, subjects, self._tel, min_status=min_status,
            block_ticks=check_every, max_blocks=max_blocks,
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
