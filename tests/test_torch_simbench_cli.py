"""The simbench twin's command line (``python -m
ringpop_tpu_torch.cli.simbench``) against the JAX package's: the same rows
by name, the same flags and record frame, the ``--telemetry`` journal, the
``--out`` file, and the device rule (the card, or the host when asked with
``--cpu``; without a card and without ``--cpu`` it runs no row and exits
nonzero).

The journal's block records of ``loss1k`` are held equal to the JAX
package's, every field of every record.
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ringpop_tpu.cli import simbench as jsb
from ringpop_tpu.sim import telemetry as jtelemetry
from ringpop_tpu_torch.cli import simbench as tsb
from ringpop_tpu_torch.sim import telemetry as ttelemetry

REPO = Path(__file__).resolve().parent.parent
CLI = [sys.executable, "-m", "ringpop_tpu_torch.cli.simbench"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_cli(*args, env_extra=None):
    import os

    env = {**os.environ, "OMP_NUM_THREADS": "1", **(env_extra or {})}
    return subprocess.run([*CLI, *args], cwd=REPO, capture_output=True, text=True, timeout=300, env=env)


def test_rows_are_the_jax_packages_rows_in_its_order():
    assert list(tsb.BENCHES) == list(jsb.BENCHES)
    assert len(tsb.BENCHES) == 25


def test_cli_ring1m_on_the_host_prints_its_record_and_writes_out(tmp_path):
    out = tmp_path / "scenarios.json"
    r = run_cli("--cpu", "--only", "ring1m", "--out", str(out))
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["bench"] == "ring1m" and line["platform"] == "cpu" and line["full_scale"] is False
    assert line["n_servers"] == 512 and line["batch"] == 100_000 and isinstance(line["wall_s"], float)
    assert "error" not in line
    saved = json.loads(out.read_text())
    assert saved == {"platform": "cpu", "full_scale": False, "scenarios": [line]}


def test_cli_telemetry_journal_equals_the_jax_rows(tmp_path, monkeypatch):
    path = tmp_path / "port.jsonl"
    r = run_cli("--cpu", "--only", "loss1k", "--telemetry", str(path))
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert result["detected"] is True
    records = ttelemetry.read_journal(str(path))
    headers = [x for x in records if x["kind"] == "header"]
    blocks = [x for x in records if x["kind"] == "block"]
    assert len(headers) == 1 and headers[0]["scenario"] == "loss1k" and headers[0]["engine"] == "lifecycle"
    assert headers[0]["params"] == {"n": 1000, "k": 128, "seed": 0}
    assert blocks and sum(b["ticks"] for b in blocks) >= result["ticks"] + result["quiescence_ticks_after_detect"]

    jpath = tmp_path / "jax.jsonl"
    monkeypatch.setattr(jsb, "_TELEMETRY_PATH", str(jpath))
    want = jsb.bench_loss1k(0, False)
    assert (want["ticks"], want["quiescence_ticks_after_detect"]) == (
        result["ticks"], result["quiescence_ticks_after_detect"])
    jblocks = [x for x in jtelemetry.read_journal(str(jpath)) if x["kind"] == "block"]
    assert len(jblocks) == len(blocks)
    for j, t in zip(jblocks, blocks):
        assert set(j) == set(t)
        for key in j:
            assert type(t[key]) is type(j[key]) and t[key] == j[key], key


def test_cli_without_a_card_and_without_cpu_runs_no_row():
    r = run_cli("--only", "loss1k", env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr and "--cpu" in r.stderr


def test_main_refuses_when_the_probe_finds_no_card(monkeypatch, capsys):
    from ringpop_tpu_torch.util import accel

    monkeypatch.setattr(accel, "probe_accelerator", lambda timeouts_s=(): {
        "alive": False, "platform": None, "probe_s": 0.0, "reason": "no CUDA device is available"})
    ran = []
    monkeypatch.setitem(tsb.BENCHES, "ring1m", lambda seed, full: ran.append(1) or {})
    assert tsb.main(["--only", "ring1m"]) == 2
    assert ran == [] and capsys.readouterr().out == ""


def test_rows_ask_for_the_card_unless_given_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for row in (tsb.bench_loss1k, tsb.bench_delta16m, tsb.bench_montecarlo, tsb.bench_ring1m):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            row(0, False)


def test_a_failing_row_is_recorded_and_the_next_one_runs(monkeypatch, capsys):
    def dies(seed, full):
        raise ValueError("boom")

    monkeypatch.setitem(tsb.BENCHES, "host10", dies)
    monkeypatch.setitem(tsb.BENCHES, "forward_comparator", lambda seed, full: {"metric": "m", "value": 1})
    out = tsb.run_rows(["host10", "forward_comparator"], 0, False, "cpu")
    assert out[0]["ok"] is False and out[0]["error"] == "ValueError: boom" and out[0]["bench"] == "host10"
    assert out[1] == {"metric": "m", "value": 1, "bench": "forward_comparator", "platform": "cpu",
                      "full_scale": False, "wall_s": out[1]["wall_s"]}
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines == out


def test_simbench_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, ringpop_tpu_torch, ringpop_tpu_torch.cli.simbench\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ringpop_tpu')]\n"
            "assert ringpop_tpu_torch.__version__ == '0.1.0'\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
