"""Scenario-grid compiler: parameter sweeps as one batched fleet.

Counterpart of ``ringpop_tpu/sim/scenarios.py``, plan for plan and verdict
for verdict: sweep a protocol-parameter grid — background-churn dose ×
packet loss × partition width × suspicion timeout (× topology overlays) —
into a stacked ``[B, ...]`` ``chaos.FaultPlan``, run it through the
Monte-Carlo fleet (``sim/montecarlo.py``), and reduce the results into
2-D response surfaces and dose cliffs.

Grid axes and where they live:

* **churn dose** — per-scenario background crash cohorts, drawn with
  EXACTLY the rng sequence ``montecarlo.detection_latency_under_churn``
  draws (``churn_dose_masks``), so the loss-0 row of the churn×loss
  surface is the ``mc_churn`` 1-D slice;
* **loss** — the scalar ``drop_rate`` leg, batched ``[B]`` (a 0.0 rate is
  value-identical to no drop leg);
* **partition width** — an optional symmetric split window (minority
  fraction per scenario; width 0 = no partition leg for that member);
* **suspicion timeout** — the ``suspect_ticks`` plan leg (-1 = the static
  param), so the timeout axis rides the batch; ``sweep_static`` remains
  for parameters the params fix;
* **topology overlays** — ``sim/topology.py`` scenario plans merged into
  grid members.

The scored path (``scored_fleet`` / ``FleetSweep``) carries the telemetry
counters one accumulator a replica and reduces them per scenario, one
fetch for all scenarios a journal block; ``chaos.score_blocks`` turns each
scenario's block slice into a verdict with its grid coordinates attached.
``FleetSweep`` checkpoints mid-sweep (the multi-process store,
``sim/snapshot.save_carry_orbax``, plus the JAX package's JSON sidecars)
and restores bit-exactly, onto another process count or a fleet mesh.  A
sweep may be process-sliced (``global_b``: each process its
``partition.process_block`` of the grid) or block-sharded over a fleet
mesh (``mesh=``), not both.  The surfaces' ``aot=`` sends their fleet
detection program through the warm start (``util/aot.py``).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.parallel import multihost
from ringpop_tpu_torch.sim import chaos
from ringpop_tpu_torch.sim.chaos import FaultPlan
from ringpop_tpu_torch.sim.lifecycle import LifecycleParams
from ringpop_tpu_torch.sim.montecarlo import MonteCarlo

_MESH_AND_SLICE = ("process-sliced sweeps checkpoint their local slice; a device mesh on top would need two "
                   "partitioning owners")


# -- grid construction (host-side) --------------------------------------------


def mc_churn_doses(b_count: int, churn_max: int) -> list[int]:
    """The dose ladder ``detection_latency_under_churn`` uses: dose j =
    round(j/(B-1)·churn_max)."""
    return [round(b / max(b_count - 1, 1) * churn_max) for b in range(b_count)]


def churn_dose_masks(
    n: int, victims: Sequence[int], doses: Sequence[int], churn_seed: int
) -> np.ndarray:
    """``up[D, N]`` masks, one per dose: the study victims plus ``dose``
    background crashes, from one ``np.random.default_rng(churn_seed)``
    (one ``choice`` per non-zero dose, in dose order)."""
    victims = sorted(int(v) for v in victims)
    rng = np.random.default_rng(churn_seed)
    candidates = np.setdiff1d(np.arange(n), np.asarray(victims, np.int64))
    up = np.ones((len(doses), n), bool)
    up[:, victims] = False
    for j, dose in enumerate(doses):
        if dose:
            down = rng.choice(candidates, size=int(dose), replace=False)
            up[j, down] = False
    return up


def scenario_grid(
    n: int,
    *,
    victims: Sequence[int],
    doses: Sequence[int],
    losses: Sequence[float] = (0.0,),
    parts: Sequence[float] = (0.0,),
    suspects: Sequence[Optional[int]] = (None,),
    overlays: Optional[Sequence[tuple[str, Optional[FaultPlan]]]] = None,
    churn_seed: int = 1234,
    part_from: int = 0,
    part_until: Optional[int] = None,
    device: DeviceLike = None,
) -> tuple[FaultPlan, list[dict]]:
    """Compile a (overlay × suspicion-timeout × loss × part × churn-dose)
    grid into ONE stacked plan on ``device`` (the card unless the caller
    asks for the CPU) plus its meta table.

    Returns ``(plan, meta)``: ``plan`` is the ``[B, ...]`` stacked FaultPlan
    (loss-major / dose-minor inside each overlay/timeout cell), ``meta[i]``
    carries ``scenario_id``, the grid coordinates (``churn``/``loss``/
    ``part``, plus ``suspect``/``overlay`` when those axes are swept) and
    ``dose_index`` — scenario i runs at ``base_seed + dose_index``
    (``grid_seeds``).  A non-zero ``part`` adds a symmetric split window
    ``[part_from, part_until)`` over the first ``part`` fraction of nodes;
    each ``suspects`` value rides the ``suspect_ticks`` leg (None = the
    params' timeout); ``overlays`` are ``(label, plan-or-None)`` pairs
    merged into every member (leg collisions refused by
    ``chaos._merge_plans``)."""
    dev = resolve_device(device)
    masks = churn_dose_masks(n, victims, doses, churn_seed)
    plans, meta = [], []
    for olabel, overlay in (overlays if overlays is not None else ((None, None),)):
        for suspect in suspects:
            for loss in losses:
                for part in parts:
                    for j, dose in enumerate(doses):
                        legs = dict(
                            base_up=chaos._leg("base_up", masks[j], dev),
                            drop_rate=chaos._leg("drop_rate", np.float32(loss), dev),
                        )
                        if part > 0:
                            group = np.zeros(n, np.int32)
                            group[: int(part * n)] = 1
                            legs.update(
                                group=chaos._leg("group", group, dev),
                                part_from=chaos._leg("part_from", np.int32(part_from), dev),
                                part_until=chaos._leg(
                                    "part_until",
                                    np.int32(part_until if part_until is not None else chaos.NO_TICK), dev),
                            )
                        if suspect is not None:
                            legs["suspect_ticks"] = chaos._leg("suspect_ticks", np.int32(suspect), dev)
                        member = FaultPlan(**legs)
                        if overlay is not None:
                            member = chaos._merge_plans(member, overlay)
                        plans.append(member)
                        m = {
                            "scenario_id": len(meta),
                            "churn": int(dose),
                            "loss": float(loss),
                            "part": float(part),
                            "dose_index": j,
                        }
                        if tuple(suspects) != (None,):
                            m["suspect"] = None if suspect is None else int(suspect)
                        if overlays is not None:
                            m["overlay"] = olabel
                        meta.append(m)
    return chaos.stack_plans(plans), meta


def grid_seeds(meta: list[dict], base_seed: int) -> list[int]:
    """Per-scenario seeds reusing the 1-D churn slice's pairing: scenario
    i runs at ``base_seed + dose_index``."""
    return [base_seed + m["dose_index"] for m in meta]


def sweep_static(values: Sequence[int], run_fn) -> dict:
    """A static outer axis: ``run_fn(value)`` once per value (for
    parameters the params fix: k, maxP, exchange flavor).  Returns
    {value: result}."""
    return {int(v): run_fn(int(v)) for v in values}


# -- fleet runners ------------------------------------------------------------


def detect_surface(
    params: LifecycleParams,
    plan: FaultPlan,
    seeds: Sequence[int],
    victims: Sequence[int],
    *,
    max_ticks: int = 4096,
    check_every: int = 1,
    aot: Optional[str] = None,
    device: DeviceLike = None,
) -> tuple[np.ndarray, np.ndarray, dict]:
    """First-detection ticks for every scenario of a stacked plan, through
    one fleet detection run (1-tick resolution by default).  Returns
    ``(ticks[B], detected[B], aot_info)``; ``aot_info`` carries the front
    door's measured ``cache_hit`` / ``compile_s`` when a tag was given
    (``{}`` otherwise)."""
    mc = MonteCarlo(params, seeds, aot=aot, device=device)
    ticks, detected = mc.run_until_detected(victims, plan, max_ticks=max_ticks, check_every=check_every)
    return ticks, detected, next(iter(mc.aot_info.values()), {})


def sequential_detect(
    params: LifecycleParams,
    plan: FaultPlan,
    seeds: Sequence[int],
    victims: Sequence[int],
    *,
    max_ticks: int = 4096,
    check_every: int = 1,
    fresh_compile: bool = True,
    device: DeviceLike = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The baseline the fleet replaces: B sequential solo runs, one per
    scenario.  ``fresh_compile`` is accepted for the JAX package's
    signature and changes nothing: the port compiles no program per run
    (its kernels are built once per source), so there is no cache to
    clear between runs."""
    del fresh_compile
    ticks = np.full(len(seeds), -1, np.int64)
    detected = np.zeros(len(seeds), bool)
    for b, seed in enumerate(seeds):
        mc = MonteCarlo(params, [seed], device=device)
        t, d = mc.run_until_detected(
            victims, chaos.index_plan(plan, b), max_ticks=max_ticks, check_every=check_every)
        ticks[b], detected[b] = int(t[0]), bool(d[0])
    return ticks, detected


def scored_fleet(
    params: LifecycleParams,
    plan: FaultPlan,
    meta: list[dict],
    seeds: Sequence[int],
    *,
    horizon: int,
    journal_every: int = 16,
    sink=None,
    scenario: str = "mc_chaos",
    device: DeviceLike = None,
) -> list[dict]:
    """Run the fleet for ``horizon`` ticks with the telemetry counters on,
    journal one block record per (scenario, block) — one fetch for all
    scenarios a block — and reduce each scenario's journal slice into a
    ``chaos.score_blocks`` verdict carrying its grid coordinates.  ``sink``
    (a ``telemetry.TelemetrySink`` or None) receives every per-scenario
    block record and, when it journals, every score record.  The one-shot
    wrapper around :class:`FleetSweep`."""
    sweep = FleetSweep(
        params, plan, meta, seeds, horizon=horizon,
        journal_every=journal_every, sink=sink, scenario=scenario, device=device,
    )
    sweep.run()
    return sweep.scores()


FLEET_CKPT_VERSION = 1


class FleetSweep:
    """A resumable long-horizon scored sweep: B scenarios stepped in
    lockstep journal blocks with the telemetry counters on, checkpointable
    between blocks and restorable bit-exactly, also onto another process
    count.

    The checkpoint carry is (batched engine state + batched telemetry
    counters), written into the multi-process store
    (``snapshot.save_carry_orbax``: each process its own rows); sweep
    progress and the already-fetched per-scenario block records ride the
    JAX package's JSON sidecars, ``<path>.meta/rank<r>.json`` a process
    (block records are native JSON scalars, so the round trip is
    value-exact and the resumed run's verdicts equal the unbroken run's bit
    for bit).

    Process slicing: process r of P builds this class over
    ``chaos.slice_plan(plan, lo, hi)`` / ``meta[lo:hi]`` / ``seeds[lo:hi]``
    (``lo, hi = partition.process_block(B, r, P)``) with ``global_b=B``; at
    save its slice is placed on ``montecarlo.fleet_save_mesh`` by
    ``partition.fleet_shard_put``, so every process writes only its rows,
    and a restore at another process count reads only the rows of its new
    slice.  ``mesh`` (a ``montecarlo.make_fleet_mesh`` mesh, over the whole
    grid) block-shards the fleet instead; the two together raise
    ValueError.

    ``obs`` (duck-typed: ``block_record(rec)``, ``progress(done, horizon,
    last_checkpoint_tick=...)``, ``sync()``) and ``on_block(sweep)`` are
    host-side hooks called after each block's records are journaled; they
    cannot change what the fleet computed.
    """

    def __init__(
        self,
        params: LifecycleParams,
        plan: FaultPlan,
        meta: list[dict],
        seeds: Sequence[int],
        *,
        horizon: int,
        journal_every: int = 16,
        sink=None,
        scenario: str = "mc_chaos",
        mesh=None,
        global_b: Optional[int] = None,
        telemetry_tiers: Optional[bool] = None,
        obs=None,
        on_block=None,
        device: DeviceLike = None,
    ):
        if len(meta) != len(list(seeds)):
            raise ValueError(f"{len(meta)} meta entries vs {len(list(seeds))} seeds")
        self.params, self.plan = params, plan
        self.meta, self.seeds = list(meta), list(seeds)
        self.horizon, self.journal_every = horizon, journal_every
        self.sink, self.scenario = sink, scenario
        self.global_b = len(self.meta) if global_b is None else global_b
        # meta carries grid-global scenario ids; a process slice keeps them,
        # so the id base is the first entry's id
        self.id_base = self.meta[0]["scenario_id"] if self.meta else 0
        ids = [m["scenario_id"] for m in self.meta]
        if ids != list(range(self.id_base, self.id_base + len(ids))):
            raise ValueError(
                "meta scenario_ids must be contiguous (a process_block "
                f"slice of the grid); got {ids[:4]}..."
            )
        if mesh is not None and self.sliced:
            raise ValueError(_MESH_AND_SLICE)
        # a topology-carrying plan arms the per-tier suspicion counters
        tiers = plan.tier_ids is not None if telemetry_tiers is None else telemetry_tiers
        self.mc = MonteCarlo(params, self.seeds, telemetry=True, telemetry_tiers=tiers, mesh=mesh, device=device)
        self.blocks: dict[int, list[dict]] = {i: [] for i in ids}
        self.ticks_done = 0
        self.resumed: Optional[dict] = None
        self.obs = obs
        self.on_block = on_block
        self._last_checkpoint_tick: Optional[int] = None

    @property
    def sliced(self) -> bool:
        """Is this sweep one process's slice of a larger grid?"""
        return self.global_b != len(self.meta)

    def header_params(self) -> dict:
        """Restore-proof fields for a journal header (OBSERVABILITY.md
        fleet-checkpoint schema): where the sweep stands and — after a
        restore — where it came from."""
        out = {
            "fleet_b": len(self.meta),
            "global_b": self.global_b,
            "id_base": self.id_base,
            "horizon": self.horizon,
            "journal_every": self.journal_every,
            "ticks_done": self.ticks_done,
        }
        if self.resumed is not None:
            out["resumed"] = dict(self.resumed)
        return out

    def run(self, until_tick: Optional[int] = None) -> "FleetSweep":
        """Step to ``until_tick`` (default: the horizon) in journal blocks —
        exactly ``horizon`` total ticks: full blocks plus one short
        remainder block when ``journal_every`` does not divide.
        ``until_tick`` must land on a block boundary: checkpoints live
        between blocks, so a resumed run replays the identical blocks."""
        target = self.horizon if until_tick is None else min(until_tick, self.horizon)
        if target % self.journal_every and target != self.horizon:
            raise ValueError(
                f"until_tick={target} is not a journal block boundary "
                f"(journal_every={self.journal_every}) — checkpoints live "
                "between blocks"
            )
        while self.ticks_done < target:
            step = min(self.journal_every, self.horizon - self.ticks_done)
            self.mc.advance(step, self.plan)
            self.ticks_done += step
            for rec in self.mc.fetch_telemetry(self.plan, id_base=self.id_base):
                self.blocks[rec["scenario_id"]].append(rec)
                # obs first (it never raises): if the sink dies on this
                # record, the flight ring already holds it
                if self.obs is not None:
                    self.obs.block_record(rec)
                if self.sink is not None:
                    self.sink(rec)
            if self.obs is not None:
                self.obs.progress(self.ticks_done, self.horizon, last_checkpoint_tick=self._last_checkpoint_tick)
                self.obs.sync()
            if self.on_block is not None:
                self.on_block(self)
        return self

    def scores(self) -> list[dict]:
        """Per-scenario ``chaos.score_blocks`` verdicts over every block
        this sweep has seen — including, after a restore, the pre-kill
        blocks read back from the checkpoint sidecars."""
        scores = []
        for b, m in enumerate(self.meta):
            gid = m["scenario_id"]
            sc = chaos.score_blocks(
                self.blocks[gid],
                chaos.index_plan(self.plan, b),
                n=self.params.n,
                scenario=self.scenario,
                scenario_id=gid,
            )
            sc.update({k: v for k, v in m.items() if k != "scenario_id"})
            scores.append(sc)
            if self.sink is not None and getattr(self.sink, "journal", None) is not None:
                self.sink.journal.score(sc)
        return scores

    def digests(self) -> dict[int, int]:
        """{global scenario_id: state digest} for this sweep's scenarios (D1
        once a replica on the card)."""
        return {self.id_base + i: d for i, d in enumerate(self.mc.digests())}

    # -- checkpointing --------------------------------------------------------

    def _own_rows(self) -> None:
        """A process slice must be the process's ``process_block`` of the
        grid to restore: that is where the store's rows are read from (a
        save checks the same in ``partition.fleet_shard_put``)."""
        from ringpop_tpu_torch.parallel.partition import process_block

        nprocs = multihost.process_count()
        want = process_block(self.global_b, multihost.process_index(), nprocs) if nprocs > 1 else (0, self.global_b)
        if (self.id_base, self.id_base + len(self.meta)) != want:
            raise ValueError(
                f"this process holds scenarios [{self.id_base}, {self.id_base + len(self.meta)}) of "
                f"{self.global_b}; its process_block is {list(want)}")

    def save(self, path: str) -> None:
        """Checkpoint mid-sweep: the carry into the store at ``path`` (each
        process writing only its rows, or on a fleet mesh its blocks) plus
        this process's JSON sidecar under ``<path>.meta/`` carrying progress,
        the config and its fetched block records.  A collective over the
        job's processes."""
        import glob as _glob

        from ringpop_tpu_torch.parallel.partition import fleet_shard_put, place_blocks
        from ringpop_tpu_torch.sim import snapshot
        from ringpop_tpu_torch.sim.montecarlo import fleet_save_mesh

        states, tel = self.mc.local_blocks()
        carry = {"states": states, "telemetry": tel}
        if self.mc.mesh is not None:
            carry = place_blocks(carry, self.mc.mesh, batch_axes=1)
        elif self.sliced:
            carry = fleet_shard_put(carry, fleet_save_mesh(), self.global_b)
        rank, nprocs = multihost.process_index(), multihost.process_count()
        meta_dir = path + ".meta"
        if rank == 0:
            # an earlier save's sidecars go before the store's first barrier
            for old in _glob.glob(os.path.join(meta_dir, "rank*.json")):
                os.remove(old)
        snapshot.save_carry_orbax(path, carry)
        os.makedirs(meta_dir, exist_ok=True)
        sidecar = {
            "version": FLEET_CKPT_VERSION,
            "scenario": self.scenario,
            "params": repr(self.params),
            "global_b": self.global_b,
            "lo": self.id_base,
            "hi": self.id_base + len(self.meta),
            "ticks_done": self.ticks_done,
            "horizon": self.horizon,
            "journal_every": self.journal_every,
            "process_count": nprocs,
            "blocks": {str(k): v for k, v in self.blocks.items()},
        }
        tmp = os.path.join(meta_dir, f"rank{rank}.json.tmp{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(sidecar, f)
        os.replace(tmp, os.path.join(meta_dir, f"rank{rank}.json"))
        multihost.barrier()
        self._last_checkpoint_tick = self.ticks_done
        if self.obs is not None:
            self.obs.progress(self.ticks_done, self.horizon, last_checkpoint_tick=self.ticks_done)

    @classmethod
    def restore(
        cls,
        path: str,
        params: LifecycleParams,
        plan: FaultPlan,
        meta: list[dict],
        seeds: Sequence[int],
        *,
        sink=None,
        scenario: Optional[str] = None,
        mesh=None,
        global_b: Optional[int] = None,
        telemetry_tiers: Optional[bool] = None,
        obs=None,
        device: DeviceLike = None,
    ) -> "FleetSweep":
        """Resume a killed sweep, at this process count, which need not be
        the saver's.  ``plan``/``meta``/``seeds`` are the caller's
        reconstruction of its slice of the grid (deterministic in its
        config; ``chaos.slice_plan`` and ``partition.process_block`` re-slice
        it), or of the whole grid with a fleet ``mesh``; the carry restores
        into a fresh sweep on ``device``, each process reading only the
        stored rows (or blocks) of its own, validated leaf by leaf, and the
        pre-kill block records merge back from every process's sidecar so
        the final verdicts cover the whole horizon."""
        import glob as _glob

        from ringpop_tpu_torch.sim import snapshot
        from ringpop_tpu_torch.sim.montecarlo import fleet_save_mesh, fleet_shardings

        meta_dir = path + ".meta"
        sidecars = []
        for p in sorted(_glob.glob(os.path.join(meta_dir, "rank*.json"))):
            with open(p) as f:
                sidecars.append(json.load(f))
        if not sidecars:
            raise ValueError(f"{path}: no fleet checkpoint sidecars in {meta_dir}")
        head = sidecars[0]
        if head.get("version") != FLEET_CKPT_VERSION:
            raise ValueError(
                f"{path}: fleet checkpoint version {head.get('version')} "
                f"(this build reads {FLEET_CKPT_VERSION})"
            )
        for key in ("ticks_done", "horizon", "journal_every", "global_b", "params"):
            vals = {json.dumps(s.get(key)) for s in sidecars}
            if len(vals) > 1:
                raise ValueError(f"{path}: sidecars disagree on {key!r}: {vals}")
        if head["params"] != repr(params):
            raise ValueError(
                f"{path}: checkpoint was taken with {head['params']}, "
                f"restore asked for {params!r}"
            )
        sweep = cls(
            params, plan, meta, seeds,
            horizon=head["horizon"], journal_every=head["journal_every"],
            sink=sink, scenario=scenario or head.get("scenario", "mc_chaos"),
            mesh=mesh, global_b=global_b, telemetry_tiers=telemetry_tiers,
            obs=obs, device=device,
        )
        if sweep.global_b != head["global_b"]:
            raise ValueError(
                f"{path}: checkpoint holds a B={head['global_b']} fleet, "
                f"restore sliced B={sweep.global_b}"
            )
        example = sweep.mc.whole_spec(sweep.global_b)
        if mesh is not None:
            shardings = fleet_shardings(example, mesh)
        elif sweep.sliced:
            sweep._own_rows()
            shardings = fleet_shardings(example, fleet_save_mesh())
        else:
            shardings = None
        carry = snapshot.load_carry_orbax(path, example, shardings, device=sweep.mc.device)
        sweep.mc.set_local_blocks(carry["states"], carry["telemetry"])
        sweep.ticks_done = head["ticks_done"]
        sweep._last_checkpoint_tick = head["ticks_done"]
        for s in sidecars:
            for gid_s, recs in s.get("blocks", {}).items():
                gid = int(gid_s)
                if gid in sweep.blocks:
                    sweep.blocks[gid] = list(recs)
        sweep.resumed = {
            "from_tick": head["ticks_done"],
            "checkpoint": os.path.abspath(path),
            "saved_process_count": head.get("process_count"),
            "restored_process_count": multihost.process_count(),
        }
        return sweep


# -- surface reduction --------------------------------------------------------


def response_surface(
    meta: list[dict],
    values: Sequence,
    *,
    rows: str = "loss",
    cols: str = "churn",
) -> dict:
    """Reduce per-scenario values into a 2-D response surface keyed by two
    grid axes.  Cells with several scenarios take the median of their
    non-null values; cells where every value is null stay null.  Returns
    ``{"row_axis", "rows", "col_axis", "cols", "cells"}`` with
    ``cells[i][j]`` the value at (rows[i], cols[j])."""
    row_vals = sorted({m[rows] for m in meta})
    col_vals = sorted({m[cols] for m in meta})
    buckets: dict[tuple, list] = {}
    for m, v in zip(meta, values):
        buckets.setdefault((m[rows], m[cols]), []).append(v)
    cells = []
    for r in row_vals:
        row = []
        for c in col_vals:
            got = [v for v in buckets.get((r, c), []) if v is not None]
            row.append(float(np.median(got)) if got else None)
        cells.append(row)
    return {
        "row_axis": rows,
        "rows": row_vals,
        "col_axis": cols,
        "cols": col_vals,
        "cells": cells,
    }


def locate_cliff(curve: Sequence[tuple]) -> tuple[Optional[int], Optional[float]]:
    """The dose at the largest jump between consecutive detected points of
    a dose-response curve ``[(dose, ticks-or-None), ...]``:

    * fewer than two detected points → ``(None, None)``;
    * no positive jump → ``(None, 0.0)``;
    * otherwise ``(dose, jump)`` at the largest jump, ties to the larger
      dose.
    """
    pts = [(c, t) for c, t in curve if t is not None]
    if len(pts) < 2:
        return None, None
    jump, at = max((t2 - t1, c2) for (_, t1), (c2, t2) in zip(pts, pts[1:]))
    if jump <= 0:
        return None, 0.0
    return at, jump


# -- adaptive cliff search ----------------------------------------------------


def dose_mask_table(
    n: int, victims: Sequence[int], max_dose: int, churn_seed: int
) -> np.ndarray:
    """``up[max_dose + 1, N]`` — every dose's churn mask at 1-dose
    resolution, by the sequential rng rule of :func:`churn_dose_masks` over
    ``0..max_dose``: the table the adaptive search and its dense baseline
    both index."""
    return churn_dose_masks(n, victims, list(range(max_dose + 1)), churn_seed)


def _points_plan(masks: np.ndarray, points: Sequence[tuple], device: DeviceLike = None) -> FaultPlan:
    """A stacked plan for explicit ``(dose, loss)`` points — always the
    same two legs (``base_up``, ``drop_rate``)."""
    dev = resolve_device(device)
    return chaos.stack_plans([
        FaultPlan(
            base_up=chaos._leg("base_up", masks[d], dev),
            drop_rate=chaos._leg("drop_rate", np.float32(l), dev),
        )
        for d, l in points
    ])


class _CliffRunner:
    """Dispatch harness for the adaptive search: a fixed-width fleet
    (width in replica slots) evaluated repeatedly with (plan, seed) swaps
    through ``MonteCarlo.reset_states``.  Each (dose, loss) point occupies
    ``seeds_per_point`` slots (seeds ``base_seed + dose·S + j``); its value
    is the median first-detection tick over those replicas.  Short rounds
    pad by repeating their last point (padding costs slots, reported in
    ``slots``, but no new evaluations: ``cache`` is the unique-evaluation
    ledger)."""

    def __init__(self, params, victims, masks, width, *, base_seed,
                 max_ticks, check_every, aot, seeds_per_point=1, device: DeviceLike = None):
        if width % seeds_per_point:
            raise ValueError(
                f"width {width} must be a multiple of seeds_per_point "
                f"{seeds_per_point}"
            )
        self.params, self.victims, self.masks = params, victims, masks
        self.width, self.base_seed = width, base_seed
        self.max_ticks, self.check_every = max_ticks, check_every
        self.aot = aot
        self.spp = seeds_per_point
        self.device = resolve_device(device)
        self.mc: Optional[MonteCarlo] = None
        self.dispatches = 0
        self.slots = 0
        self.cache: dict[tuple, Optional[float]] = {}

    def eval(self, points: Sequence[tuple]) -> dict:
        todo = [p for p in dict.fromkeys(points) if p not in self.cache]
        per = self.width // self.spp
        while todo:
            chunk, todo = todo[:per], todo[per:]
            batch = chunk + [chunk[-1]] * (per - len(chunk))
            slots = [(pt, j) for pt in batch for j in range(self.spp)]
            seeds = [self.base_seed + d * self.spp + j for (d, _), j in slots]
            if self.mc is None:
                self.mc = MonteCarlo(self.params, seeds, aot=self.aot, device=self.device)
            else:
                self.mc.reset_states(seeds)
            ticks, det = self.mc.run_until_detected(
                self.victims,
                _points_plan(self.masks, [pt for pt, _ in slots], self.device),
                max_ticks=self.max_ticks, check_every=self.check_every,
            )
            self.dispatches += 1
            self.slots += self.width
            for i, pt in enumerate(batch):
                reps = [
                    (float(t) if d else None)
                    for t, d in zip(
                        ticks[i * self.spp:(i + 1) * self.spp],
                        det[i * self.spp:(i + 1) * self.spp],
                    )
                ]
                if pt not in self.cache:
                    if all(r is None for r in reps):
                        self.cache[pt] = None
                    else:
                        self.cache[pt] = float(np.median([
                            self.max_ticks if r is None else r for r in reps
                        ]))
        return {p: self.cache[p] for p in points}

    def result_fields(self) -> dict:
        tagged = self.mc is not None and self.aot is not None
        return {
            "evals_unique": len(self.cache) * self.spp,
            "evals_dispatched": self.slots,
            "dispatches": self.dispatches,
            "width": self.width,
            "seeds_per_point": self.spp,
            "all_detected": all(v is not None for v in self.cache.values()),
            # compiled programs are counted only under an AOT tag
            "compiled_programs": len(self.mc._aot_calls) if tagged else None,
            "aot": next(iter(self.mc.aot_info.values()), {}) if tagged else {},
        }


def refine_surface(
    params: LifecycleParams,
    *,
    victims: Sequence[int],
    losses: Sequence[float],
    max_dose: int,
    coarse: int = 9,
    base_seed: int = 0,
    churn_seed: int = 1234,
    max_ticks: int = 4096,
    check_every: int = 1,
    aot: Optional[str] = None,
    masks: Optional[np.ndarray] = None,
    cells_per_row: int = 2,
    verify_window: int = 2,
    seeds_per_point: int = 1,
    device: DeviceLike = None,
) -> dict:
    """Adaptive cliff search: locate each loss row's dose cliff at 1-dose
    resolution in O(log max_dose) fleet runs instead of a dense grid.

    A coarse pass (``coarse`` evenly spaced doses per row, one fleet run)
    ranks each row's cells by first-detection jump; the top
    ``cells_per_row`` are candidates.  Then each round evaluates every
    active cell's midpoint (all rows and cells share one run), keeps the
    half with the larger jump (ties keep the upper half) and stops at
    width 1.  A final verify run evaluates the ±``verify_window`` 1-dose
    neighborhood of every candidate, and the row's answer is the largest
    jump over adjacent evaluated dose pairs (ties to the larger dose).

    Rows whose coarse curve has fewer than two detected points report
    ``(None, None)``; rows with no positive jump ``(None, 0.0)`` — the
    :func:`locate_cliff` contract.  Undetected points inside an active cell
    count as ``max_ticks``; ``all_detected`` says whether that happened.

    Returns ``{"cliffs": {loss: {"cliff_at", "jump", "cell"}}, "points":
    {loss: [(dose, tick-or-None), ...]}}`` plus the run ledger
    (``evals_unique``/``evals_dispatched``/``dispatches``/``width``)."""
    if coarse < 3:
        raise ValueError(f"coarse={coarse}: need at least 3 coarse doses")
    if max_dose < 2:
        raise ValueError(f"max_dose={max_dose}: nothing to refine")
    losses = tuple(float(l) for l in losses)
    if masks is None:
        masks = dose_mask_table(params.n, victims, max_dose, churn_seed)
    coarse_doses = sorted({
        int(round(i * max_dose / (coarse - 1))) for i in range(coarse)
    })
    runner = _CliffRunner(
        params, victims, masks,
        width=len(coarse_doses) * len(losses) * seeds_per_point,
        base_seed=base_seed, max_ticks=max_ticks, check_every=check_every,
        aot=aot, seeds_per_point=seeds_per_point, device=device,
    )
    got = runner.eval([(d, l) for l in losses for d in coarse_doses])

    def t_of(d, l):
        v = runner.cache[(d, l)]
        return max_ticks if v is None else v

    cells: dict[float, list[tuple[int, int]]] = {}
    cliffs: dict = {}
    for l in losses:
        curve = [(d, got[(d, l)]) for d in coarse_doses]
        det = [(d, t) for d, t in curve if t is not None]
        if len(det) < 2:
            cliffs[l] = {"cliff_at": None, "jump": None, "cell": None}
            cells[l] = []
            continue
        ranked = sorted(
            ((t2 - t1, d1, d2) for (d1, t1), (d2, t2) in zip(det, det[1:])),
            reverse=True,
        )
        if ranked[0][0] <= 0:
            cliffs[l] = {"cliff_at": None, "jump": 0.0, "cell": None}
            cells[l] = []
            continue
        cells[l] = [
            (d1, d2) for jump, d1, d2 in ranked[:cells_per_row] if jump > 0
        ]
    while True:
        active = [
            (l, i) for l, cs in cells.items()
            for i, (lo, hi) in enumerate(cs) if hi - lo > 1
        ]
        if not active:
            break
        mids = []
        for l, i in active:
            lo, hi = cells[l][i]
            mids.append(((lo + hi) // 2, l))
        runner.eval(mids)
        for l, i in active:
            lo, hi = cells[l][i]
            m = (lo + hi) // 2
            jl = t_of(m, l) - t_of(lo, l)
            jh = t_of(hi, l) - t_of(m, l)
            cells[l][i] = (m, hi) if jh >= jl else (lo, m)
    extra = []
    for l, cs in cells.items():
        for lo, hi in cs:
            for d in range(hi - 1 - verify_window, hi + 1 + verify_window):
                if 0 <= d <= max_dose:
                    extra.append((d, l))
    if extra:
        runner.eval(extra)
    for l in losses:
        if not cells[l]:
            continue
        evald = sorted(d for (d, ll) in runner.cache if ll == l)
        pairs = [
            (t_of(d2, l) - t_of(d1, l), d2)
            for d1, d2 in zip(evald, evald[1:]) if d2 == d1 + 1
        ]
        jump, at = max(pairs)
        if jump <= 0:
            cliffs[l] = {"cliff_at": None, "jump": 0.0, "cell": None}
            continue
        cell = next(
            ([lo, hi] for lo, hi in cells[l] if hi == at), [at - 1, at]
        )
        cliffs[l] = {"cliff_at": at, "jump": jump, "cell": cell}
    points = {
        l: sorted((d, t) for (d, ll), t in runner.cache.items() if ll == l)
        for l in losses
    }
    return {
        "losses": list(losses),
        "max_dose": max_dose,
        "coarse_doses": coarse_doses,
        "cliffs": cliffs,
        "points": points,
        **runner.result_fields(),
    }


def dense_surface(
    params: LifecycleParams,
    *,
    victims: Sequence[int],
    losses: Sequence[float],
    max_dose: int,
    base_seed: int = 0,
    churn_seed: int = 1234,
    max_ticks: int = 4096,
    check_every: int = 1,
    aot: Optional[str] = None,
    masks: Optional[np.ndarray] = None,
    width: Optional[int] = None,
    seeds_per_point: int = 1,
    device: DeviceLike = None,
) -> dict:
    """The baseline :func:`refine_surface` replaces: every dose
    ``0..max_dose`` of every loss row evaluated through the fleet (one run,
    or chunks of ``width``), cliffs located by :func:`locate_cliff` on the
    full 1-dose curves.  Shares the ``dose_mask_table`` and the seed
    pairing with the adaptive search."""
    losses = tuple(float(l) for l in losses)
    if masks is None:
        masks = dose_mask_table(params.n, victims, max_dose, churn_seed)
    points = [(d, l) for l in losses for d in range(max_dose + 1)]
    runner = _CliffRunner(
        params, victims, masks,
        width=width or len(points) * seeds_per_point,
        base_seed=base_seed, max_ticks=max_ticks, check_every=check_every,
        aot=aot, seeds_per_point=seeds_per_point, device=device,
    )
    got = runner.eval(points)
    cliffs = {}
    curves = {}
    for l in losses:
        curve = [(d, got[(d, l)]) for d in range(max_dose + 1)]
        curves[l] = curve
        at, jump = locate_cliff(curve)
        cliffs[l] = {"cliff_at": at, "jump": jump}
    return {
        "losses": list(losses),
        "max_dose": max_dose,
        "cliffs": cliffs,
        "curves": curves,
        **runner.result_fields(),
    }
