"""Game days: score the closed loop against a no-controller twin.

Counterpart of ``ringpop_tpu/obs/gameday.py``.  The fleet, its telemetry
and the DGRO-placed serve ring live on ``device`` (the card by default);
the rules, the controller and the obs fabric are host code.

A game day injects an r18 correlated-failure scenario (zone cut,
switch flap) into a live P=2 fleet — LocalKV threads, the same obs
fabric code paths real OS processes run — with the FULL reflex arc
attached on rank 0: ``AggregatingStats`` → ``RuleEngine`` →
``OpsController`` → ``RingStore`` drain, all evaluated at the
``FleetSweep.on_block`` protocol point.  The judged quantity is
**time-to-mitigate**:

* controller run — ticks from the injected cut to the controller's
  successful ``drain`` action (the cut zone's serve node routed away by
  a generation commit);
* twin run (same seeds, controller off) — ticks from the cut until
  SWIM's organic route-around completes (``detect_frac`` reaches 1.0 in
  the journal: every faulty member declared, membership fully reflects
  the cut).

The controller acts on the probe-timeout SPIKE (visible one journal
block after the cut), while declaration must wait out ``suspect_ticks``
plus dissemination — so a working loop mitigates strictly earlier, and
:func:`gameday_pair` asserts it.  Both runs must land bit-identical
sim digests (the loop is host-side policy over seams that existed
before it; it can trigger serve-plane commits, never sim arithmetic) —
the digest bar that lets the controller ship without re-baselining a
single committed artifact.

Mapping note: the sim fleet and the serve mesh are joined by
CONVENTION here — one serve node per topology zone (``z0``…), and the
harness tells the controller which zone a fleet-wide degradation names
(``server_of``).  A live mesh (ROADMAP "run the protocol for real")
derives that subject from per-rank ``/healthz`` staleness instead; the
rules/controller layers are identical either way.

torch-free at import; the sim stack loads inside :func:`run_gameday`.
"""

from __future__ import annotations

import threading
from typing import Optional

from ringpop_tpu_torch.obs.controller import OpsController
from ringpop_tpu_torch.obs.endpoint import LiveOps
from ringpop_tpu_torch.obs.flight import FlightRecorder
from ringpop_tpu_torch.obs.rules import CrossRankSkew, RateOfChange, RuleEngine, Staleness
from ringpop_tpu_torch.obs.trace import chain

SCENARIOS = ("zone_cut", "switch_flap")

# the gameday's serve-mesh convention: one serve node per zone of the
# default 2x2x2 topology tree
N_ZONES = 4


def _build_plan(scenario: str, n: int, cut_at: int, journal_every: int, device=None):
    from ringpop_tpu_torch.sim import chaos, topology

    topo = topology.default_topology(n)
    if scenario == "zone_cut":
        solo = topology.zone_loss_plan(topo, 0, at=cut_at, device=device)
    elif scenario == "switch_flap":
        solo = topology.switch_flap_plan(
            topo, 0, period=4 * journal_every,
            down=2 * journal_every, start=cut_at, device=device,
        )
    else:
        raise ValueError(f"scenario must be one of {SCENARIOS}; got {scenario!r}")
    # B=2: the same correlated event under two seeds, one scenario per
    # fleet rank (the minimal process-sliced sweep)
    plan = chaos.stack_plans([solo, solo])
    meta = [
        {"scenario_id": i, "event": scenario, "rep": i} for i in range(2)
    ]
    return topo, plan, meta


def organic_mitigation_tick(
    blocks: list[dict], cut_at: int = 0
) -> Optional[int]:
    """The twin's mitigation point: end tick of the first journal block
    AFTER the cut where every faulty member is both declared
    (``census_faulty > 0``) and detected (``detect_frac >= 1.0`` —
    membership, and therefore the reference system's ring, fully
    reflects the cut).  ``detect_frac`` is trivially 1.0 while nothing
    is faulty, so both conditions are required.  None if the horizon
    ends first."""
    for rec in blocks:
        if (
            int(rec.get("tick", -1)) > cut_at
            and float(rec.get("census_faulty", 0.0)) > 0.0
            and float(rec.get("detect_frac", 0.0)) >= 1.0
        ):
            return int(rec["tick"])
    return None


def run_gameday(
    *,
    scenario: str = "zone_cut",
    n: int = 64,
    seed: int = 0,
    horizon: int = 48,
    journal_every: int = 8,
    cut_at: Optional[int] = None,
    controller: bool = True,
    flight_dir: Optional[str] = None,
    device=None,
) -> dict:
    """One P=2 game-day run on ``device`` (the card by default); returns
    the scorecard dict.

    Keys: ``digests`` (both ranks merged), ``alerts``/``actions``
    (journal records), ``mitigation_tick`` (controller) /
    ``organic_tick`` (always), ``ttm`` (whichever applies),
    ``chain`` (the drain action's reconstructed span chain), plus the
    run config.  ``controller=False`` runs the digest-twin: identical
    fleet, rules still evaluated (alerts are observation), no actions.
    """
    import numpy as np

    from ringpop_tpu_torch.parallel.fabric import LocalKV
    from ringpop_tpu_torch.parallel.partition import process_block
    from ringpop_tpu_torch.sim import chaos, scenarios
    from ringpop_tpu_torch.sim.lifecycle import LifecycleParams
    from ringpop_tpu_torch.device import resolve_device
    from ringpop_tpu_torch.serve.state import RingStore

    dev = resolve_device(device)
    if cut_at is None:
        cut_at = 2 * journal_every  # one full baseline delta before it
    _topo, plan, meta = _build_plan(scenario, n, cut_at, journal_every, dev)
    params = LifecycleParams(n=n, k=32, suspect_ticks=10, rng="counter")
    seeds = [seed, seed + 101]
    nprocs = 2
    ns = f"gameday-{scenario}-{seed}-{int(controller)}"

    # -- the serve plane the controller acts on (rank 0, host-side) ----------
    store = RingStore(
        [f"z{z}" for z in range(N_ZONES)], replica_points=32,
        placement="dgro", placement_kw={"candidates": 2, "probes": 1 << 10},
        device=dev,
    )
    probe_keys = [f"probe-{i}" for i in range(512)]
    probe_hashes = np.asarray(
        [store.ring.hashfunc(k) & 0xFFFFFFFF for k in probe_keys], np.uint32
    )

    def drain_probe(server: str) -> int:
        owners = store.ring.lookup_batch(probe_keys)
        return sum(1 for o in owners if o == server)

    # -- the reflex arc (rank 0) ----------------------------------------------
    journal: list[dict] = []  # kind:"alert"/"action" records, in order
    recorder = FlightRecorder(
        capacity=256, rank=0,
        path=None if flight_dir is None else f"{flight_dir}/gameday-flight.jsonl",
    )

    def sink(rec: dict) -> None:
        journal.append(rec)
        recorder(rec)

    engine = RuleEngine(
        [
            # the fast signal: probe-timeout delta jumps 5-20x the block
            # after a zone cut (self-calibrating — see rules.py)
            RateOfChange(
                id="probe-timeout-spike", key="ringpop.sim.ping.timeout",
                source="counters", spike_ratio=4.0,
                floor=max(1.0, 0.01 * n * journal_every),
                per_rank=False, hold=1,
            ),
            # quiet-by-construction rules ride along: a healthy gameday
            # must NOT fire them (asserted by the smoke)
            CrossRankSkew(
                id="serve-load-skew", key="ringpop.serve.keys.share",
                source="gauges", ratio=1.5, hold=2,
            ),
            Staleness(id="rank-stale", hold=2),
        ],
        sink=sink,
    )
    ctl = (
        OpsController(
            sink=sink,
            policy={
                "probe-timeout-spike": "drain",
                "serve-load-skew": "dgro_rescore",
                "rank-stale": "resize",
            },
            ring_store=store,
            # fleet-wide degradation maps to the cut zone's serve node
            # (harness convention — see the module docstring)
            server_of=lambda _subject: "z0",
            drain_probe=drain_probe,
            recorder=recorder,
            cooldown=1_000_000,  # one shot per game day
        )
        if controller
        else None
    )

    mitigation = {"tick": None}
    kv = LocalKV()
    opses: list = [None, None]
    sweeps: list = [None, None]
    digests: list = [None, None]
    errs: list = [None, None]
    ready = threading.Barrier(nprocs, timeout=120)

    def make_on_block(rank: int, ops: "LiveOps"):
        def on_block(sweep) -> None:
            # every rank gauges its serve-process key share (the
            # CrossRankSkew input — forward.batch.rank_load over the
            # committed ring against the fixed probe population)
            try:
                from ringpop_tpu_torch.forward.batch import rank_load

                toks, _owners, _gen, _ns = store.snapshot_host()
                share = rank_load(toks, probe_hashes, nprocs)[rank]
                ops.stats.gauge("ringpop.serve.keys.share", float(share))
            except Exception:
                pass  # the ops plane never takes the run down
            if rank != 0:
                return
            alerts = engine.evaluate(
                ops.snapshots(), health=ops.health(),
                tick=sweep.ticks_done,
            )
            if ctl is None:
                return
            for act in ctl.on_alerts(alerts, tick=sweep.ticks_done):
                if (
                    act.get("action") == "drain"
                    and act.get("ok")
                    and mitigation["tick"] is None
                ):
                    mitigation["tick"] = sweep.ticks_done

        return on_block

    def worker(rank: int) -> None:
        try:
            ops = LiveOps(
                rank, nprocs, kv=kv, namespace=ns,
                recorder=recorder if rank == 0 else None,
            )
            opses[rank] = ops
            ready.wait()
            lo, hi = process_block(len(meta), rank, nprocs)
            sweep = scenarios.FleetSweep(
                params, chaos.slice_plan(plan, lo, hi), meta[lo:hi],
                seeds[lo:hi], horizon=horizon,
                journal_every=journal_every, scenario="gameday",
                global_b=len(meta), obs=ops,
                on_block=make_on_block(rank, ops), device=dev,
            )
            sweep.run()
            sweeps[rank] = sweep
            digests[rank] = sweep.digests()
        except BaseException as e:  # noqa: BLE001
            errs[rank] = e
        finally:
            if opses[rank] is not None:
                opses[rank].close()

    threads = [
        threading.Thread(target=worker, args=(r,), name=f"gameday-r{r}")
        for r in range(nprocs)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if any(errs):
        raise RuntimeError(f"gameday rank died: {errs}")

    merged_digests: dict[int, int] = {}
    for d in digests:
        merged_digests.update(d or {})
    blocks0 = sweeps[0].blocks[0]
    organic = organic_mitigation_tick(blocks0, cut_at)
    mit = mitigation["tick"]
    ttm = (
        (mit - cut_at)
        if controller and mit is not None
        else ((organic if organic is not None else horizon) - cut_at)
    )
    drain_actions = [
        r for r in journal
        if r.get("kind") == "action" and r.get("action") == "drain"
    ]
    chains = [chain(journal, a["trace"]) for a in drain_actions]
    return {
        "scenario": scenario,
        "controller": controller,
        "n": n,
        "seed": seed,
        "horizon": horizon,
        "journal_every": journal_every,
        "cut_at": cut_at,
        "digests": merged_digests,
        "alerts": [r for r in journal if r.get("kind") == "alert"],
        "actions": [r for r in journal if r.get("kind") == "action"],
        "mitigation_tick": mit,
        "organic_tick": organic,
        "ttm": ttm,
        "chains": chains,
        "ring_gen": store.gen,
        "flight_dumps": dict(recorder.dumps),
    }


def bare_digests(
    *, scenario: str = "zone_cut", n: int = 64, seed: int = 0,
    horizon: int = 48, journal_every: int = 8,
    cut_at: Optional[int] = None, device=None,
) -> dict:
    """The HEAD oracle: the identical fleet on P=1 with NO obs plane,
    no rules, no controller — what today's committed code computes.
    The controller-off twin (and, by the host-side-only construction,
    the controller-on run) must match these digests bit for bit; the
    smoke asserts it, which is what lets r22 ship without re-baselining
    any committed artifact."""
    from ringpop_tpu_torch.device import resolve_device
    from ringpop_tpu_torch.sim import scenarios
    from ringpop_tpu_torch.sim.lifecycle import LifecycleParams

    dev = resolve_device(device)
    if cut_at is None:
        cut_at = 2 * journal_every
    _topo, plan, meta = _build_plan(scenario, n, cut_at, journal_every, dev)
    params = LifecycleParams(n=n, k=32, suspect_ticks=10, rng="counter")
    sweep = scenarios.FleetSweep(
        params, plan, meta, [seed, seed + 101], horizon=horizon,
        journal_every=journal_every, scenario="gameday", device=dev,
    )
    sweep.run()
    return sweep.digests()


def gameday_pair(
    *, scenario: str = "zone_cut", n: int = 64, seed: int = 0,
    horizon: int = 48, journal_every: int = 8, device=None,
) -> dict:
    """Controller run + digest-identical twin, judged, on ``device``.  Returns the two
    scorecards plus the verdict fields the smoke/simbench/certify
    layers all read: ``digest_equal``, ``ttm_on``/``ttm_off``, and
    ``mitigated_earlier`` (the acceptance bar: strictly better)."""
    on = run_gameday(
        scenario=scenario, n=n, seed=seed, horizon=horizon,
        journal_every=journal_every, controller=True, device=device,
    )
    off = run_gameday(
        scenario=scenario, n=n, seed=seed, horizon=horizon,
        journal_every=journal_every, controller=False, device=device,
    )
    return {
        "scenario": scenario,
        "on": on,
        "off": off,
        "digest_equal": on["digests"] == off["digests"],
        "ttm_on": on["ttm"],
        "ttm_off": off["ttm"],
        "mitigated_earlier": on["ttm"] < off["ttm"],
    }
