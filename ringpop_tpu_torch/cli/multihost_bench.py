"""One rank of a multi-process delta run (counterpart of
``ringpop_tpu/cli/multihost_bench.py``: the same legs, flags and record
keys).

Started by ``ringpop_tpu_torch.cli.multihost_launch``: reads the rendezvous
(``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``), brings up the
process group over gloo (it carries only the checkpoint store's barriers;
the fabric carries the data), builds the host-bridged DCN fabric over the
group's ``TCPStore`` (``fabric.DistributedKV``) and runs one leg on this
rank's device, emitting JSONL records to ``MULTIHOST_JSONL`` and stdout.

Legs::

    twin              — step a seeded scenario T ticks; emit the global
                        state digest (the 1/2/4-process bit-identity twin)
    converge          — run delta convergence through the fabric with a
                        journal every --journal-every ticks; emit ticks,
                        digest, peaks and fabric bytes
    snapshot-save     — step T ticks, write the block-sharded checkpoint,
                        emit the digest at save
    snapshot-restore  — restore the checkpoint AT THIS PROCESS COUNT (need
                        not match the saver's), continue E ticks, emit the
                        digest

Records carry ``device_peak_mb`` (``torch.cuda.max_memory_allocated`` since
the leg began; null on the host) beside ``peak_rss_mb``.  Without a
rendezvous in the environment it runs as a single process, the same code
path as P = 2 and 4.  The device is the launcher's ``MULTIHOST_DEVICE``
(``cpu`` runs on the host), else the card.
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
    print(line, flush=True)


def _peak_rss_mb() -> float:
    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0, 1)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="multihost_bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("leg", choices=["twin", "converge", "snapshot-save", "snapshot-restore"])
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--k", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ticks", type=int, default=24)
    p.add_argument("--extra-ticks", type=int, default=8)
    p.add_argument("--max-ticks", type=int, default=4096)
    p.add_argument("--journal-every", type=int, default=64)
    p.add_argument("--victims", type=int, default=0)
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--path", default=None, help="checkpoint directory (snapshot legs)")
    p.add_argument("--journal-light", action="store_true",
                   help="periodic converge-leg journal records skip the state digest; the exit record is "
                   "always full")
    p.add_argument("--codec", choices=["on", "off"], default="on",
                   help="wire codec (zero-row/run suppression + XOR-delta); 'off' ships raw frames")
    p.add_argument("--schedule", choices=["cyclic", "swing"], default="cyclic",
                   help="window-exchange schedule: 'cyclic' direct sends or 'swing' distance-halving relay "
                   "rounds (power-of-two P)")
    p.add_argument("--overlap", choices=["on", "off"], default="off",
                   help="cross-tick pipelining: sends drain on the fabric's threads while the next tick runs")
    return p.parse_args(argv)


def leg_faults(args, device):
    """The leg's ``DeltaFaults``: ``--victims`` nodes down (drawn as the JAX
    package's bench draws them) and ``--drop`` loss, or None."""
    if not (args.victims or args.drop):
        return None
    import numpy as np
    import torch

    from ringpop_tpu_torch.sim.delta import DeltaFaults

    kw = {}
    if args.victims:
        rng = np.random.default_rng(args.seed + 999)
        up = np.ones(args.n, bool)
        up[rng.choice(args.n, size=args.victims, replace=False)] = False
        kw["up"] = torch.from_numpy(up).to(device)
    if args.drop:
        kw["drop_rate"] = torch.tensor(args.drop, dtype=torch.float32, device=device)
    return DeltaFaults(**kw)


def _device_peak_mb(device):
    import torch

    return round(torch.cuda.max_memory_allocated(device) / 2**20, 1) if device.type == "cuda" else None


def run_leg(args, rank: int, nprocs: int, kv, device, namespace: str | None = None, emit=_emit):
    """Run the leg ``args`` names on a fabric of ``nprocs`` ranks over
    ``kv`` (namespace ``mhb-<leg>`` unless given), this rank's block on
    ``device``; the device's peak is reset first.  Emits the leg's records
    through ``emit`` (None: none) and returns (the last record, the
    engine)."""
    import torch

    from ringpop_tpu_torch.parallel.fabric import Fabric
    from ringpop_tpu_torch.sim.delta import DeltaParams
    from ringpop_tpu_torch.sim.delta_multihost import MultihostDelta

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    emit = emit or (lambda rec: None)
    fabric = Fabric(rank, nprocs, kv, namespace=namespace or f"mhb-{args.leg}", codec=args.codec == "on")
    params = DeltaParams(n=args.n, k=args.k, rng="counter")
    faults = leg_faults(args, device)
    engine_kw = dict(faults=faults, schedule=args.schedule, overlap=args.overlap == "on", device=device)
    t0 = time.perf_counter()
    try:
        if args.leg == "twin":
            mh = MultihostDelta(params, fabric, seed=args.seed, **engine_kw)
            for _ in range(args.ticks):
                mh.step()
            rec = {"kind": "twin", **mh.journal_record(), "wall_s": round(time.perf_counter() - t0, 3),
                   "peak_rss_mb": _peak_rss_mb(), "device_peak_mb": _device_peak_mb(device)}
        elif args.leg == "converge":
            mh = MultihostDelta(params, fabric, seed=args.seed, **engine_kw)
            ticks, ok = mh.run_until_converged(
                max_ticks=args.max_ticks, sink=lambda r: emit({"kind": "block", **r}),
                journal_every=args.journal_every, journal_light=args.journal_light,
            )
            wall = time.perf_counter() - t0
            ws = fabric.wire_stats()
            rec = {
                "kind": "result",
                "ticks": ticks,
                "converged": ok,
                "digest": mh.state_digest(),
                "wall_s": round(wall, 3),
                "ms_per_tick": round(1000.0 * wall / max(ticks, 1), 3),
                "peak_rss_mb": _peak_rss_mb(),
                "device_peak_mb": _device_peak_mb(device),
                "fabric_bytes_sent": ws["bytes_sent"],
                "fabric_bytes_recv": ws["bytes_recv"],
                "fabric_raw_sent": ws["raw_bytes_sent"],
                "fabric_mb_per_tick": round(ws["bytes_sent"] / max(ticks, 1) / 1e6, 3),
                "fabric_raw_mb_per_tick": round(ws["raw_bytes_sent"] / max(ticks, 1) / 1e6, 3),
                "fabric_codec_ratio": round(ws["raw_bytes_sent"] / ws["bytes_sent"], 4)
                if ws["bytes_sent"] else 1.0,
                "fabric_codec_counts": ws["codec_counts"],
                "d2h_bytes": mh.d2h_bytes,
                "codec": args.codec,
                "schedule": args.schedule,
                "overlap": args.overlap == "on",
                **mh.leg_timing(),
                "process_count": nprocs,
                "process_id": rank,
                "n": args.n,
                "k": args.k,
            }
        elif args.leg == "snapshot-save":
            mh = MultihostDelta(params, fabric, seed=args.seed, **engine_kw)
            for _ in range(args.ticks):
                mh.step()
            mh.save_snapshot(args.path)
            rec = {"kind": "saved", "tick": mh.tick, "digest": mh.state_digest(), "process_count": nprocs,
                   "peak_rss_mb": _peak_rss_mb(), "device_peak_mb": _device_peak_mb(device)}
        else:  # snapshot-restore
            mh = MultihostDelta.restore_snapshot(args.path, params, fabric, **engine_kw)
            restored_digest = mh.state_digest()
            for _ in range(args.extra_ticks):
                mh.step()
            rec = {"kind": "restored", "tick": mh.tick, "digest_at_restore": restored_digest,
                   "digest": mh.state_digest(), "process_count": nprocs, "peak_rss_mb": _peak_rss_mb(),
                   "device_peak_mb": _device_peak_mb(device)}
        emit(rec)
    finally:
        fabric.close()
    return rec, mh


def main(argv=None) -> int:
    args = parse_args(argv)

    from ringpop_tpu_torch.device import resolve_device
    from ringpop_tpu_torch.parallel import multihost
    from ringpop_tpu_torch.parallel.fabric import DistributedKV, LocalKV

    device = resolve_device(os.environ.get("MULTIHOST_DEVICE") or None)
    if device.type == "cuda":
        import torch

        torch.cuda.set_device(device)
    distributed = multihost.init_distributed(transport="gloo")
    nprocs = multihost.process_count() if distributed else 1
    rank = multihost.process_index() if distributed else 0
    kv = DistributedKV() if distributed else LocalKV()
    try:
        run_leg(args, rank, nprocs, kv, device)
        multihost.barrier()  # rank 0 serves the store: no rank leaves before the others are done with it
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
