"""Start N coordinated rank processes of one ``torch.distributed`` job on
this host (counterpart of ``scripts/multihost_launch.py``).

Every rank gets the rendezvous the port's ``multihost.init_distributed``
reads — ``MASTER_ADDR`` (127.0.0.1), ``MASTER_PORT`` (a free port),
``WORLD_SIZE``, ``RANK`` — plus ``MULTIHOST_JSONL``, the file its records go
to (collected after exit), and ``MULTIHOST_DEVICE``, its device: rank r gets
the card ``cuda:{r % cards}``, or the device the caller names (``cpu`` for a
run on the host).  Importable: :func:`launch`.  CLI::

    python -m ringpop_tpu_torch.cli.multihost_launch --nprocs 2 -- \\
        -m ringpop_tpu_torch.cli.multihost_bench twin --n 65536 --k 64 --ticks 24
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
from typing import Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# rendezvous variables of the JAX package's launcher: init_distributed reads
# them before torchrun's, so a rank must not inherit them
_JAX_RENDEZVOUS = ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_devices(nprocs: int, device: Optional[str] = None) -> list[str]:
    """Each rank's device: ``device`` for every rank when named, else rank r
    on the card ``cuda:{r % cards}``.  Raises RuntimeError when no device is
    named and no card is visible (a run on the host is asked for with
    ``device="cpu"``, never taken as a fallback)."""
    if device is not None:
        return [device] * nprocs
    import torch

    cards = torch.cuda.device_count()
    if not cards:
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to run the ranks on the host")
    return [f"cuda:{r % cards}" for r in range(nprocs)]


def launch(
    nprocs: int,
    argv: Sequence[str],
    timeout_s: float = 900.0,
    device: Optional[str] = None,
) -> list[dict]:
    """Run ``python <argv>`` as ``nprocs`` coordinated ranks; return one
    record per rank: ``{"rank", "rc", "records" (parsed JSONL), "stdout",
    "stderr"}``.  Raises RuntimeError on a nonzero exit or a timeout (every
    rank is then killed), so a dead worker cannot read as an empty run."""
    devices = rank_devices(nprocs, device)
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="multihost_")
    procs, logs = [], []
    try:
        for rank in range(nprocs):
            jsonl = os.path.join(tmp, f"rank{rank}.jsonl")
            logs.append(jsonl)
            env = {k: v for k, v in os.environ.items() if k not in _JAX_RENDEZVOUS}
            env.update({
                "MASTER_ADDR": "127.0.0.1",
                "MASTER_PORT": str(port),
                "WORLD_SIZE": str(nprocs),
                "RANK": str(rank),
                "MULTIHOST_JSONL": jsonl,
                "MULTIHOST_DEVICE": devices[rank],
                "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
            })
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, cwd=REPO,
            ))
        # drain every rank's pipes concurrently: a rank that fills its pipe
        # while an earlier one is waited for would stall the whole job
        drained: list = [None] * nprocs

        def drain(rank: int, p) -> None:
            try:
                drained[rank] = p.communicate(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                drained[rank] = p.communicate() + ("timeout",)

        threads = [threading.Thread(target=drain, args=(r, p), daemon=True) for r, p in enumerate(procs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        out, failure = [], None
        for rank, p in enumerate(procs):
            stdout, stderr = drained[rank][0], drained[rank][1]
            if len(drained[rank]) > 2:
                failure = failure or f"rank {rank} timed out after {timeout_s}s"
            records = []
            if os.path.exists(logs[rank]):
                with open(logs[rank]) as f:
                    records = [json.loads(line) for line in f if line.strip()]
            out.append({"rank": rank, "rc": p.returncode, "records": records, "stdout": stdout, "stderr": stderr})
            if p.returncode != 0 and failure is None:
                failure = f"rank {rank} rc={p.returncode}\nstdout: {stdout[-800:]}\nstderr: {stderr[-3000:]}"
        if failure:
            raise RuntimeError(f"multihost launch failed: {failure}")
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--device", default=None,
                   help="every rank's device (e.g. cpu); default: rank r on cuda:{r %% cards}")
    p.add_argument("cmd", nargs=argparse.REMAINDER, help="worker argv after '--' (passed to python)")
    args = p.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        p.error("worker command required after --")
    for r in launch(args.nprocs, cmd, timeout_s=args.timeout, device=args.device):
        for rec in r["records"]:
            print(json.dumps({"rank": r["rank"], **rec}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
