"""One rank of a scenario-fleet certification run (counterpart of
``ringpop_tpu/cli/fleet_bench.py``: the same legs, flags and record keys).

Started by ``ringpop_tpu_torch.cli.multihost_launch`` (simbench's
``fleet_scale``): reads the rendezvous (``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK``), brings up the process group over gloo (it
carries the checkpoint store's barriers), slices the deterministic
scenario grid by ``partition.process_block`` over its batch axis, runs its
slice as a ``scenarios.FleetSweep`` on this rank's device and emits JSONL
records to ``MULTIHOST_JSONL``.

Legs::

    sweep          — scored sweep over this rank's batch slice to the
                     horizon; emits per-scenario state digests + score
                     verdicts + peak RSS.  ``--save-at T --path D``
                     additionally checkpoints the whole fleet carry at
                     tick T (each process writing only its blocks) and
                     CONTINUES — a mid-sweep save does not perturb the run.
    sweep-restore  — restore the checkpoint AT THIS PROCESS COUNT (need
                     not match the saver's), continue to the horizon,
                     emit the same digests/scores record.

The grid is a pure function of (n, k, doses, losses, seed), so every
process count builds the same B scenarios and any slicing of them is
bit-exact per scenario (``chaos.slice_plan``).  Without a rendezvous it
runs as a single process, the same code path as P = 2 and 4.  Records
carry ``device_peak_mb`` (``torch.cuda.max_memory_allocated`` over the leg;
null on the host) beside ``peak_rss_mb``, and ``launches``, the kernel
wrappers' launch counts over the leg.  The device is the launcher's
``MULTIHOST_DEVICE`` (``cpu`` runs on the host), else the card.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time


def _emit(rec: dict) -> None:
    path = os.environ.get("MULTIHOST_JSONL")
    line = json.dumps(rec)
    if path:
        with open(path, "a") as f:
            f.write(line + "\n")
        # stdout gets a summary only: the full record is large at fleet
        # scale, and the launcher reads the records from the JSONL file
        line = json.dumps({
            k: rec.get(k)
            for k in ("kind", "b", "b_local", "lo", "hi", "ticks_done", "wall_s", "peak_rss_mb", "device_peak_mb",
                      "process_id", "saved_at")
            if k in rec
        })
    print(line, flush=True)


def _peak_rss_mb() -> float:
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1)


def _device_peak_mb(device):
    import torch

    return round(torch.cuda.max_memory_allocated(device) / 2**20, 1) if device.type == "cuda" else None


def build_grid(args, device):
    """The deterministic grid every rank (and every process count) builds
    alike: victims drawn like the mc_chaos scenario, the shared churn-dose
    ladder, loss rows, ``grid_seeds`` pairing."""
    import numpy as np

    from ringpop_tpu_torch.sim import scenarios

    rng = np.random.default_rng(args.seed)
    victims = sorted(rng.choice(args.n, size=4, replace=False).tolist())
    doses = scenarios.mc_churn_doses(args.b_doses, args.churn_max or args.n // 32)
    losses = tuple(float(x) for x in args.losses.split(","))
    plan, meta = scenarios.scenario_grid(
        args.n, victims=victims, doses=doses, losses=losses, churn_seed=args.seed + 777, device=device,
    )
    seeds = scenarios.grid_seeds(meta, args.seed)
    return victims, plan, meta, seeds


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="fleet_bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("leg", choices=["sweep", "sweep-restore"])
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--k", type=int, default=64)
    p.add_argument("--b-doses", type=int, default=32)
    p.add_argument("--losses", default="0.0,0.1")
    p.add_argument("--churn-max", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--suspect-ticks", type=int, default=10)
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--journal-every", type=int, default=16)
    p.add_argument("--save-at", type=int, default=0,
                   help="sweep leg: checkpoint the carry at this tick (a journal block boundary), then continue")
    p.add_argument("--path", default=None, help="fleet checkpoint dir")
    p.add_argument("--live-port", type=int, default=int(os.environ.get("RINGPOP_OBS_PORT", "0") or 0),
                   help="serve the live operations plane (/metrics /healthz /progress) on this port (0 = off; "
                   "RINGPOP_OBS_PORT = base + rank)")
    return p.parse_args(argv)


def _live_ops(args, rank: int, nprocs: int, distributed: bool):
    """The opt-in live operations plane: a pull endpoint a rank, rank 0
    aggregating over its own obs fabric, and a flight recorder.  It never
    takes the rank down: a failed bring-up runs the sweep dark and a failed
    bind keeps the collector, both reported.  Returns (ops, address)."""
    ops = None
    try:
        from ringpop_tpu_torch.obs.endpoint import LiveOps
        from ringpop_tpu_torch.obs.flight import FlightRecorder

        kv = None
        if distributed and nprocs > 1:
            from ringpop_tpu_torch.parallel.fabric import DistributedKV

            kv = DistributedKV()
        recorder = FlightRecorder(rank=rank).install()
        ops = LiveOps(rank, nprocs, recorder=recorder, kv=kv)
    except Exception as e:  # noqa: BLE001
        print(json.dumps({"kind": "live", "rank": rank, "error": f"{type(e).__name__}: {e}"}), flush=True)
        return None, None
    try:
        addr = ops.serve(port=args.live_port)
    except OSError as e:
        print(json.dumps({"kind": "live", "rank": rank, "error": f"bind: {e}"}), flush=True)
        return ops, None
    print(json.dumps({"kind": "live", "rank": rank, "addr": addr}), flush=True)
    return ops, addr


def run_leg(args, rank: int, nprocs: int, device, ops=None) -> dict:
    """This rank's slice of the leg ``args`` names, on ``device``; returns
    its record (the device's peak and the launch counts over the leg)."""
    import torch

    from ringpop_tpu_torch.parallel.partition import process_block
    from ringpop_tpu_torch.sim import chaos, scenarios
    from ringpop_tpu_torch.sim.lifecycle import LifecycleParams
    from ringpop_tpu_torch.util import aot

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    before = aot.launch_counts()
    params = LifecycleParams(n=args.n, k=args.k, suspect_ticks=args.suspect_ticks, rng="counter")
    victims, plan, meta, seeds = build_grid(args, device)
    b = len(meta)
    lo, hi = process_block(b, rank, nprocs) if nprocs > 1 else (0, b)
    plan_s = chaos.slice_plan(plan, lo, hi)
    meta_s, seeds_s = meta[lo:hi], seeds[lo:hi]
    t0 = time.perf_counter()
    save_s = None
    if args.leg == "sweep":
        sweep = scenarios.FleetSweep(params, plan_s, meta_s, seeds_s, horizon=args.horizon,
                                     journal_every=args.journal_every, scenario="fleet_scale", global_b=b, obs=ops,
                                     device=device)
        if args.save_at:
            sweep.run(until_tick=args.save_at)
            ts = time.perf_counter()
            sweep.save(args.path)
            save_s = round(time.perf_counter() - ts, 3)
        sweep.run()
    else:
        sweep = scenarios.FleetSweep.restore(args.path, params, plan_s, meta_s, seeds_s, scenario="fleet_scale",
                                             global_b=b, obs=ops, device=device)
        sweep.run()
    digests = {str(k_): v for k_, v in sweep.digests().items()}
    scores = sweep.scores()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    after = aot.launch_counts()
    rec = {
        "kind": args.leg,
        "n": args.n,
        "k": args.k,
        "b": b,
        "b_local": len(meta_s),
        "lo": lo,
        "hi": hi,
        "horizon": args.horizon,
        "ticks_done": sweep.ticks_done,
        "victims": victims,
        "digests": digests,
        "scores": scores,
        "wall_s": round(time.perf_counter() - t0, 3),
        "peak_rss_mb": _peak_rss_mb(),
        "device_peak_mb": _device_peak_mb(device),
        "launches": {name: after[name] - before[name] for name in after},
        "process_count": nprocs,
        "process_id": rank,
        **sweep.header_params(),
    }
    if args.leg == "sweep" and args.save_at:
        rec["saved_at"] = args.save_at
        rec["save_s"] = save_s
    return rec


def main(argv=None) -> int:
    args = parse_args(argv)

    from ringpop_tpu_torch.device import resolve_device
    from ringpop_tpu_torch.parallel import multihost
    from ringpop_tpu_torch.util.accel import configure_compile_cache

    device = resolve_device(os.environ.get("MULTIHOST_DEVICE") or None)
    if device.type == "cuda":
        import torch

        torch.cuda.set_device(device)
    distributed = multihost.init_distributed(transport="gloo")
    configure_compile_cache()
    nprocs = multihost.process_count() if distributed else 1
    rank = multihost.process_index() if distributed else 0
    ops, live_addr = _live_ops(args, rank, nprocs, distributed) if args.live_port else (None, None)
    try:
        rec = run_leg(args, rank, nprocs, device, ops)
        if live_addr is not None:
            rec["live_addr"] = live_addr
        _emit(rec)
        if ops is not None:
            ops.close()
        # ranks can finish far apart (host-side scoring on shared cores);
        # rank 0 serves the store: no rank leaves before the others are done
        multihost.barrier()
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
