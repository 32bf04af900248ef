"""The port's ``cli/fleet_bench`` (one rank of simbench's ``fleet_scale``)
against the JAX package's, at a small size on the CPU: the JAX worker's
``sweep`` at P = 1 in a subprocess is the reference; the port's worker,
started by ``cli/multihost_launch`` over gloo, runs ``sweep`` at P = 1,
``sweep --save-at`` at P = 2 and ``sweep-restore`` of that checkpoint at
P = 1.  Every scenario's digest and score equals the JAX run's, and the
records and stdout summaries carry the JAX worker's keys, with the device
peak and the launch counts beside them.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ringpop_tpu_torch.cli import multihost_launch

REPO = Path(__file__).resolve().parent.parent
GRID = ["--n", "128", "--k", "32", "--b-doses", "2", "--losses", "0.0,0.1", "--horizon", "8", "--journal-every", "4"]
PORT = ["-m", "ringpop_tpu_torch.cli.fleet_bench"]
PORT_ONLY = {"device_peak_mb", "launches"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _one_thread_a_rank(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the rank processes inherit it


@pytest.fixture(scope="module")
def jax_sweep(tmp_path_factory):
    """The JAX worker's sweep at P = 1: (its record, its stdout summary)."""
    out = tmp_path_factory.mktemp("jax_fleet") / "rank0.jsonl"
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_COORDINATOR") and k not in
           ("JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
    env.update(JAX_PLATFORMS="cpu", MULTIHOST_JSONL=str(out), PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "ringpop_tpu.cli.fleet_bench", "sweep", *GRID], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text().splitlines()[-1]), json.loads(proc.stdout.strip().splitlines()[-1])


def launch(nprocs, *argv):
    ranks = multihost_launch.launch(nprocs, PORT + list(argv), timeout_s=240, device="cpu")
    return [r["records"][-1] for r in ranks], [json.loads(r["stdout"].strip().splitlines()[-1]) for r in ranks]


def merged(recs):
    digests, scores = {}, []
    for r in recs:
        digests.update(r["digests"])
        scores += r["scores"]
    return digests, sorted(scores, key=lambda s: s["scenario_id"])


def test_one_process_sweep_equals_the_jax_worker(jax_sweep):
    want, want_summary = jax_sweep
    (rec,), (summary,) = launch(1, "sweep", *GRID)
    assert rec["digests"] == want["digests"] and rec["scores"] == want["scores"]
    assert set(rec) == set(want) | PORT_ONLY and set(summary) == set(want_summary) | {"device_peak_mb"}
    for key in ("kind", "n", "k", "b", "b_local", "lo", "hi", "horizon", "ticks_done", "victims", "process_count",
                "process_id"):
        assert rec[key] == want[key], key
    assert rec["b"] == 4 and rec["device_peak_mb"] is None and rec["peak_rss_mb"] > 0
    assert all(count == 0 for count in rec["launches"].values())  # the CPU runs the plain versions


def test_two_process_save_restored_at_one_equals_the_jax_worker(jax_sweep, tmp_path):
    want, _ = jax_sweep
    path = str(tmp_path / "ck")
    saved, _ = launch(2, "sweep", *GRID, "--save-at", "4", "--path", path)
    assert [(r["lo"], r["hi"], r["saved_at"], r["process_count"]) for r in saved] == [(0, 2, 4, 2), (2, 4, 4, 2)]
    assert merged(saved) == (want["digests"], want["scores"])
    assert sorted(p.name for p in Path(path).iterdir()) == ["shard-00000.npz", "shard-00001.npz"]
    (restored,), _ = launch(1, "sweep-restore", *GRID, "--path", path)
    assert restored["kind"] == "sweep-restore" and restored["ticks_done"] == 8
    assert restored["digests"] == want["digests"] and restored["scores"] == want["scores"]
    assert restored["resumed"]["saved_process_count"] == 2 and restored["resumed"]["restored_process_count"] == 1
