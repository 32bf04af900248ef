"""The port's bench twin (``python -m ringpop_tpu_torch.bench``) in FAST mode
on the CPU, against ``bench.py``'s JAX engines at the same configuration.

``BENCH_FAST=1``: lifecycle 20,000 x 64 with bench.py's 5 victims of
``default_rng(0)``, ``run_until_detected(max_ticks=4096, check_every=32,
blocks_per_dispatch=8)``, ``run_until_converged`` after it and
``view_checksums``; delta 50,000 x 64 from ``init_state(seed=1)`` with
``check_every=8``.  At each stream (threefry, bench.py's own, and counter):
equal detection and convergence ticks, equal view-checksum sum and digest,
equal delta ticks, and every final leaf's digest equal to the JAX
package's.  The record carries every key of bench.py's record (read from
its source: bench.py runs the whole benchmark when executed), the keys of
legs the port lacks null beside a reason, the timed runs listed, and the
twin refuses to run without a card unless asked for the CPU.
"""

import ast
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu_torch import bench as tb

REPO = Path(__file__).resolve().parent.parent


def bench_record_keys() -> list[str]:
    """The keys of the ``result = {...}`` record in bench.py's source."""
    tree = ast.parse((REPO / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result" for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py has no result record")


def _jax_fast(rng: str) -> dict:
    """bench.py's FAST legs through the JAX package's entry points."""
    sc = tb.scales(True)
    n, k = sc["n_life"], sc["k_life"]
    victims = np.sort(np.random.default_rng(0).choice(n, size=max(1, int(n * sc["victims_frac"])), replace=False))
    up = np.ones(n, bool)
    up[victims] = False
    faults = jd.DeltaFaults(up=jnp.asarray(up))
    sim = jl.LifecycleSim(n=n, k=k, seed=0, rng=rng)
    run = dict(max_ticks=4096, check_every=32, blocks_per_dispatch=8)
    ticks, ok = sim.run_until_detected(victims, faults, time_budget_s=900.0, **run)
    cv_ticks, cv_ok = sim.run_until_converged(faults, time_budget_s=900.0, **run)
    cs = np.asarray(jl.view_checksums(sim.state, faults)).astype("<u4")
    p = jd.DeltaParams(n=sc["n_delta"], k=sc["k_delta"], rng=rng)
    dstate, d_ticks, d_ok = jd.run_until_converged(p, jd.init_state(p, seed=1), max_ticks=4096, check_every=8)
    leaves = lambda s: jax.tree_util.tree_map(np.asarray, s)  # noqa: E731
    return {
        "victims": victims, "ticks": ticks, "detected": ok, "converge_extra_ticks": cv_ticks, "converged": cv_ok,
        "view_checksum_sum": int(cs.astype(np.uint64).sum() % 2**32),
        "view_checksum_sha256": hashlib.sha256(cs.tobytes()).hexdigest(),
        "lifecycle_final_digests": tb.leaf_digests(leaves(sim.state), jl.LifecycleState._fields),
        "delta_ticks": d_ticks, "delta_converged": d_ok,
        "delta_final_digests": tb.leaf_digests(leaves(dstate), jd.DeltaState._fields),
    }


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("rng", ["threefry", "counter"])
def test_fast_twin_matches_the_jax_package(rng):
    record = tb.run_bench("cpu", rng, fast=True, runs=2)
    want = _jax_fast(rng)
    assert np.array_equal(tb.victims_of(record["n_nodes"], tb.scales(True)["victims_frac"]), want.pop("victims"))
    for key, value in want.items():
        assert record[key] == value, key
    assert record["detected"] and record["converged"] and record["delta_converged"]
    assert record["rng"] == rng and record["platform"] == "cpu" and record["device_name"] == "cpu"
    assert (record["n_nodes"], record["n_rumor_slots"], record["n_victims"]) == (20_000, 64, 5)
    assert (record["delta_n_nodes"], record["delta_n_rumors"]) == (50_000, 64)
    assert record["metric"] == "swim_lifecycle_detect_n20000"
    assert len(record["detect_s_runs"]) == len(record["delta_converge_s_runs"]) == record["runs"] == 2
    assert record["value"] == round(float(np.median(record["detect_s_runs"])), 4)
    assert record["ring_lookup_qps"] > 0 and record["serve_lookup_qps"] > 0
    if rng == "threefry":
        assert record["lifecycle_scale_reason"] == "BENCH_FAST=1 smoke scales"


def test_record_has_every_key_of_bench_py_and_a_reason_for_each_null(monkeypatch):
    """The twin's record at FAST scale, printed as one JSON line by the
    module's entry point: bench.py's keys all present; the AOT, transport
    and baseline-ratio keys null, each group beside its reason."""
    monkeypatch.setenv("BENCH_FAST", "1")
    lines = []
    monkeypatch.setattr("builtins.print", lambda *a, **k: lines.append(" ".join(map(str, a))))
    assert tb.main(["--device", "cpu", "--runs", "1"]) == 0
    assert len(lines) == 1
    record = json.loads(lines[0])
    keys = bench_record_keys()
    assert len(keys) > 40 and "metric" in keys and "transport_rtt_us" in keys
    missing = [k for k in keys if k not in record]
    assert not missing, missing
    for key in ("delta_cache_hit", "delta_aot_compile_s", "delta_aot_error"):
        assert record[key] is None
    assert "A15" in record["delta_aot_reason"]
    for key in keys:
        if key.startswith("transport_"):
            assert record[key] is None, key
    assert "A5" in record["transport_reason"]
    for key in ("vs_baseline", "vs_baseline_at_reduced_scale", "delta_vs_baseline"):
        assert record[key] is None
    assert record["vs_baseline_reason"]
    assert record["rng"] == "threefry" and len(record["detect_s_runs"]) == 1


def test_twin_refuses_to_run_without_a_card(monkeypatch):
    """No silent CPU: the default device is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.run_bench()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main([])


def test_scales_and_victims_are_bench_py_s():
    """bench.py's lines 409-430 and 435-440: the scales per mode and the
    victim draw."""
    full, fast = tb.scales(False), tb.scales(True)
    assert (full["n_life"], full["k_life"], full["n_delta"], full["k_delta"]) == (1_000_000, 256, 1_000_000, 128)
    assert (full["n_servers"], full["batch"]) == (4096, 1_000_000)
    assert (fast["n_life"], fast["k_life"], fast["n_delta"], fast["k_delta"]) == (20_000, 64, 50_000, 64)
    assert (fast["n_servers"], fast["batch"]) == (512, 100_000)
    v = tb.victims_of(1_000_000, full["victims_frac"])
    assert v.shape == (1000,) and np.array_equal(v, np.sort(np.random.default_rng(0).choice(1_000_000, 1000,
                                                                                            replace=False)))
