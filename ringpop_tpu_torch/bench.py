"""The headline benchmark record of the repository's ``bench.py``, on the port.

    python -m ringpop_tpu_torch.bench                 # on the CUDA card
    BENCH_FAST=1 python -m ringpop_tpu_torch.bench --device cpu

Runs the legs of ``bench.py`` (its lines 395-697) at its scales and seeds,
through the port's entry points, and prints one JSON record with its keys:

* lifecycle failure detection — ``LifecycleSim(n, k, seed=0)`` with the
  victims of ``np.random.default_rng(0)`` down, ``run_until_detected(
  max_ticks=4096, check_every=32, blocks_per_dispatch=8)`` under the
  ``BENCH_TIME_BUDGET_S`` budget (900 s), then ``run_until_converged`` from
  the detected state and ``view_checksums``: 1,000,000 x 256 with 1000
  victims (``BENCH_FAST=1``: 20,000 x 64 with 5);
* delta rumor convergence — ``run_until_converged(max_ticks=4096,
  check_every=8)`` from ``init_state(seed=1)``: 1,000,000 x 128
  (``BENCH_FAST=1``: 50,000 x 64), through the warm-start front door
  (``util/aot.py``, tag ``bench-delta-n<n>k<k>``), as bench.py routes it:
  ``delta_cache_hit``, ``delta_aot_compile_s`` and ``delta_aot_error`` are
  its record;
* ``ring_lookup`` and the serve tier's ``serve_lookup_fused`` over a
  4096-server x 256-vnode ring (512 servers fast), each ten batches of
  1,000,000 hashes from ``default_rng(0)`` (100,000 fast) shifted by the
  batch number, as keys per second;
* the RPC channel — ``net.channel.TCPChannel``'s small-RPC echo round trip
  (``call_sync`` against a plain handler on the link's reader thread, 1000
  calls, 200 fast) under msgpack and under json, p50 as a trimmed
  median-of-batches and p99, and a 256 KiB body echoed 12 times (6 fast)
  as MB/s, under msgpack (bench.py's codec) or, where msgpack is not
  importable, json carrying the body as base64 text (``transport_bulk_codec``
  says which).

Both engines run ``--rng threefry`` (bench.py's own stream, the default) or
``--rng counter``; the record names it.  Detection and convergence are
host-clock times of work that ends in a device synchronize: the detection
leg is timed ``--runs`` times from a fresh state, every run listed beside
the median, which is ``value``.  The msgpack pair of the channel's round
trip is null, beside its reason, where msgpack is not importable
(``transport_msgpack_reason``: that leg is refused, never switched to
json).  Every ``vs_baseline*`` and
``transport_*_baseline*`` is null: those figures were taken on other
hardware.  The record also carries the tick counts' companions the tests
and ``chip_smoke.py`` hold against the JAX package: the final leaves'
sha256 digests of both engines and the view checksums' wrapping sum and
digest.

Without a card the twin raises unless ``--device cpu`` asks for the plain
PyTorch path; it never falls back to the CPU silently.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import statistics
import sys
import time
from typing import Optional

import numpy as np
import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.ops import _cuda_build, hash_kernel, lifecycle_kernel, packbits_kernel, threefry_kernel
from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens, ring_lookup
from ringpop_tpu_torch.serve.state import device_ring, serve_lookup_fused
from ringpop_tpu_torch.sim import delta, lifecycle
from ringpop_tpu_torch.util import aot

M32 = 0xFFFF_FFFF
CHECK_EVERY, DELTA_CHECK_EVERY, MAX_TICKS = 32, 8, 4096

# why the keys of these legs are null
BASELINE_REASON = "BASELINE.json's figures were taken on other hardware; no ratio against them is kept"
TRANSPORT_BASELINE_REASON = (
    "bench.py's transport baselines were taken on a CPU container of the TPU era; no ratio against them is kept")
MSGPACK_REASON = "msgpack is not importable here: the channel refuses the msgpack codec (no json fallback)"


def scales(fast: bool) -> dict:
    """bench.py's scales (its lines 409-430): full or ``BENCH_FAST=1``."""
    if fast:
        return {"n_delta": 50_000, "k_delta": 64, "n_life": 20_000, "k_life": 64, "victims_frac": 0.00025,
                "n_servers": 512, "batch": 100_000, "life_scale_reason": "BENCH_FAST=1 smoke scales"}
    return {"n_delta": 1_000_000, "k_delta": 128, "n_life": 1_000_000, "k_life": 256, "victims_frac": 0.001,
            "n_servers": 4096, "batch": 1_000_000, "life_scale_reason": None}


def victims_of(n: int, frac: float) -> np.ndarray:
    """bench.py's victims: ``max(1, int(n * frac))`` nodes of
    ``default_rng(0).choice``, sorted."""
    count = max(1, int(n * frac))
    return np.sort(np.random.default_rng(0).choice(n, size=count, replace=False))


def leaf_digests(leaves, fields) -> dict[str, str]:
    """sha256 of each state leaf (numpy, in the JAX package's dtypes) over
    its little-endian bytes."""
    out = {}
    for name, leaf in zip(fields, leaves):
        arr = np.ascontiguousarray(np.asarray(leaf))
        out[name] = hashlib.sha256(arr.astype(arr.dtype.newbyteorder("<")).tobytes()).hexdigest()
    return out


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for mod in (hash_kernel, packbits_kernel, lifecycle_kernel, threefry_kernel):
        mod.reset_launches()


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev: torch.device, fn):
    """(fn's result, seconds of host clock until the device is done)."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _qps(dev: torch.device, batch: int, lookup, hashes: torch.Tensor) -> float:
    """Keys per second of ``lookup`` over ten batches, batch ``i`` the hashes
    plus ``i`` in wrapping uint32; each batch's owners are summed, as
    bench.py's loop does, after one untimed pass."""
    def ten():
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(10):
            acc += lookup((hashes + i) & M32).to(torch.int64).sum()
        return acc

    ten()
    _, secs = _timed(dev, ten)
    return batch * 10 / secs


def _trimmed_batch_median(samples: list, batches: int = 8) -> float:
    """bench.py's trimmed median-of-batches: ``samples`` (in arrival order)
    in ``batches`` contiguous batches, each batch's median, the highest and
    lowest dropped, the mean of the rest."""
    n = len(samples)
    if n == 0:
        raise ValueError("no samples")
    batches = max(1, min(batches, n))
    size = n / batches
    meds = []
    for b in range(batches):
        chunk = sorted(samples[int(b * size): int((b + 1) * size)])
        if chunk:
            meds.append(chunk[len(chunk) // 2])
    meds.sort()
    if len(meds) > 2:
        meds = meds[1:-1]
    return sum(meds) / len(meds)


def _echo_pair(codec: str):
    """A listening echo server and a client channel under ``codec``: the
    in-process pair, one link, of bench.py's transport probes."""
    from ringpop_tpu_torch.net import TCPChannel

    server = TCPChannel(app="bench", codec=codec)
    server.register("bench", "/echo", lambda body, headers: body)
    client = TCPChannel(app="bench-cli", codec=codec)
    return server, client, server.listen_sync("127.0.0.1", 0)


def transport_rtt_us(reps: int, codec: str) -> dict:
    """Small-RPC echo round trip over the TCP channel (bench.py's
    ``_transport_rtt_us``): ``call_sync`` inline completion against a plain
    handler on the link's reader thread.  ``{"p50_us", "p99_us"}``."""
    server, client, addr = _echo_pair(codec)
    try:
        payload = {"x": 7, "k": "bench"}
        for _ in range(20):  # warm the link and the demux path
            client.call_sync(addr, "bench", "/echo", payload, timeout=10)
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            client.call_sync(addr, "bench", "/echo", payload, timeout=10)
            samples.append(time.perf_counter() - t0)
    finally:
        client.close_sync()
        server.close_sync()
    ordered = sorted(samples)
    return {"p50_us": _trimmed_batch_median(samples) * 1e6,
            "p99_us": ordered[min(len(ordered) - 1, (len(ordered) * 99) // 100)] * 1e6}


def transport_bulk_mbps(reps: int, codec: str, size: int = 256 * 1024) -> float:
    """Body throughput, MB/s of ``size`` payload bytes each way (bench.py's
    ``_transport_bulk_mbps``): one ``size``-byte body echoed per call, raw
    bytes under msgpack, base64 text (the channel's json array lane) under
    json."""
    from ringpop_tpu_torch.net import encode_array

    server, client, addr = _echo_pair(codec)
    try:
        payload = {"blob": encode_array(np.full(size, 0xA5, np.uint8), codec, "u1")}
        for _ in range(3):
            client.call_sync(addr, "bench", "/echo", payload, timeout=30)
        t0 = time.perf_counter()
        for _ in range(reps):
            client.call_sync(addr, "bench", "/echo", payload, timeout=30)
        dt = time.perf_counter() - t0
    finally:
        client.close_sync()
        server.close_sync()
    return (2 * reps * size) / dt / 1e6


def transport_record(fast: bool) -> dict:
    """The record's ``transport_*`` keys (bench.py:607-629 and :684-692):
    the msgpack pair, the json pair and the bulk rate; a probe that fails
    leaves its keys null with the error, never the headline."""
    from ringpop_tpu_torch.net import channel

    reps = 200 if fast else 1000
    has_msgpack = channel._msgpack is not None
    rec = {"transport_rtt_us": None, "transport_rtt_p99_us": None, "transport_rtt_baseline_us": None,
           "transport_rtt_json_us": None, "transport_rtt_json_p99_us": None,
           "transport_rtt_json_baseline_us": None, "transport_bulk_mbps": None,
           "transport_bulk_baseline_mbps": None, "transport_rtt_error": None,
           "transport_bulk_codec": "msgpack" if has_msgpack else "json",
           "transport_msgpack_reason": None if has_msgpack else MSGPACK_REASON,
           "transport_baseline_reason": TRANSPORT_BASELINE_REASON}
    try:
        if has_msgpack:
            mp = transport_rtt_us(reps, "msgpack")
            rec["transport_rtt_us"], rec["transport_rtt_p99_us"] = round(mp["p50_us"], 1), round(mp["p99_us"], 1)
        js = transport_rtt_us(reps, "json")
        rec["transport_rtt_json_us"], rec["transport_rtt_json_p99_us"] = round(js["p50_us"], 1), round(js["p99_us"], 1)
        rec["transport_bulk_mbps"] = round(transport_bulk_mbps(6 if fast else 12, rec["transport_bulk_codec"]), 1)
    except Exception as e:  # the side probe never kills the headline
        for key in ("transport_rtt_us", "transport_rtt_p99_us", "transport_rtt_json_us",
                    "transport_rtt_json_p99_us", "transport_bulk_mbps"):
            rec[key] = None
        rec["transport_rtt_error"] = f"{type(e).__name__}: {e}"
    return rec


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_bench(device: DeviceLike = None, rng: str = "threefry", fast: bool = False, runs: int = 3) -> dict:
    """Run the legs and return the record (see the module docstring)."""
    dev = resolve_device(device)
    sc = scales(fast)
    n_life, k_life = sc["n_life"], sc["k_life"]
    victims = victims_of(n_life, sc["victims_frac"])
    up = np.ones(n_life, bool)
    up[victims] = False
    faults = delta.DeltaFaults(up=torch.from_numpy(up).to(dev))
    budget = float(os.environ.get("BENCH_TIME_BUDGET_S", "900"))
    converge_budget = float(os.environ.get("BENCH_CONVERGE_BUDGET_S", "900"))

    # -- headline: lifecycle failure detection --------------------------------
    t0 = time.perf_counter()
    life = lifecycle.LifecycleSim(n=n_life, k=k_life, seed=0, rng=rng, device=dev)
    # the entry checks alone (0 blocks), as bench.py warms its programs, and
    # one tick, discarded: the kernels the path launches are built and
    # loaded at first use, outside the timed runs
    life.run_until_detected(victims, faults, max_ticks=0, check_every=CHECK_EVERY)
    life.run_until_converged(faults, max_ticks=0, check_every=CHECK_EVERY)
    lifecycle.step(life.params, life.state, faults)
    _sync(dev)
    warmup_s = time.perf_counter() - t0
    detect_runs = []
    for _ in range(runs):
        life.state = lifecycle.init_state(life.params, seed=0, device=dev)
        (life_ticks, life_ok), secs = _timed(dev, lambda: life.run_until_detected(
            victims, faults, max_ticks=MAX_TICKS, check_every=CHECK_EVERY, time_budget_s=budget,
            blocks_per_dispatch=8))
        detect_runs.append(secs)
    life_s = statistics.median(detect_runs)

    # literal convergence, continued from the (last run's) detected state
    (cv_ticks, cv_ok), converge_s = _timed(dev, lambda: life.run_until_converged(
        faults, max_ticks=MAX_TICKS, check_every=CHECK_EVERY, blocks_per_dispatch=8,
        time_budget_s=converge_budget))
    cs = lifecycle.view_checksums(life.state, faults)
    cs, checksum_s = _timed(dev, lambda: lifecycle.view_checksums(life.state, faults))
    cs_np = cs.cpu().numpy().astype("<u4")
    life_digests = leaf_digests(lifecycle.state_to_numpy(life.state), lifecycle.LifecycleState._fields)
    del life

    # -- delta rumor convergence ------------------------------------------------
    # the run goes through the warm-start front door, as bench.py's does: a
    # miss builds and loads the kernels of the program's entry check, a hit
    # (an earlier process on this card and toolchain) loads them, and
    # delta_cache_hit says which.  Then the entry check alone (0 ticks) and
    # one tick, discarded, warm the rest outside the timed runs.
    t0 = time.perf_counter()
    dparams = delta.DeltaParams(n=sc["n_delta"], k=sc["k_delta"], rng=rng)
    dfaults = delta.DeltaFaults()
    warm = delta.init_state(dparams, seed=0, device=dev)
    delta_run, delta_aot = aot.load_or_compile(
        functools.partial(delta.run_until_converged, dparams), warm, dfaults, dyn_kw={"max_ticks": 0},
        tag=f"bench-delta-n{sc['n_delta']}k{sc['k_delta']}", static_kw={"check_every": DELTA_CHECK_EVERY},
        statics=(repr(dparams),))
    delta_run(warm, dfaults, max_ticks=0)
    delta.step(dparams, warm)
    del warm
    _sync(dev)
    delta_warmup_s = time.perf_counter() - t0
    delta_runs = []
    for _ in range(runs):
        state0 = delta.init_state(dparams, seed=1, device=dev)
        (dstate, d_ticks, d_ok), secs = _timed(dev, lambda: delta_run(state0, dfaults, max_ticks=MAX_TICKS))
        delta_runs.append(secs)
    delta_s = statistics.median(delta_runs)
    delta_digests = leaf_digests(delta.state_to_numpy(dstate), delta.DeltaState._fields)
    del dstate, state0

    # -- ring_lookup and the serve tier's fused lookup ---------------------------
    servers = [f"10.0.{i // 256}.{i % 256}:3000" for i in range(sc["n_servers"])]
    tokens, owners = build_ring_tokens(servers, 256, device=dev)
    batch = sc["batch"]
    hashes = torch.from_numpy(
        np.random.default_rng(0).integers(0, 2**32, size=batch, dtype=np.uint32).astype(np.int64)).to(dev)
    ring_qps = _qps(dev, batch, lambda h: ring_lookup(tokens, owners, h), hashes)
    sring = device_ring(tokens.cpu().numpy(), owners.cpu().numpy(), 2 * int(tokens.shape[0]), device=dev)
    serve_qps = _qps(dev, batch, lambda h: serve_lookup_fused(sring, h), hashes)
    transport = transport_record(fast)

    n_victims = int(victims.shape[0])
    return {
        "metric": f"swim_lifecycle_detect_n{n_life}",
        "value": round(life_s, 4),
        "unit": "s",
        "detect_s_runs": detect_runs,
        "vs_baseline": None,
        "vs_baseline_at_reduced_scale": None,
        "vs_baseline_reason": BASELINE_REASON,
        "detected": life_ok,
        "ticks": life_ticks,
        "ticks_per_s": round(life_ticks / life_s, 3) if life_s > 0 else None,
        "sim_time_s": round(life_ticks * 0.2, 1),
        "n_nodes": n_life,
        "n_rumor_slots": k_life,
        "n_victims": n_victims,
        "warmup_s": round(warmup_s, 2),
        "lifecycle_scale_reason": sc["life_scale_reason"],
        "converge_s": round(converge_s, 4),
        "converge_extra_ticks": cv_ticks,
        "converge_total_ticks": life_ticks + cv_ticks,
        "converged": cv_ok,
        "converge_total_s": round(life_s + converge_s, 4),
        "delta_converge_s": round(delta_s, 4),
        "delta_converge_s_runs": delta_runs,
        "delta_n_nodes": sc["n_delta"],
        "delta_n_rumors": sc["k_delta"],
        "delta_ticks": d_ticks,
        "delta_converged": d_ok,
        "delta_vs_baseline": None,
        "delta_compile_s": round(delta_warmup_s, 2),
        "delta_cache_hit": delta_aot["cache_hit"],
        "delta_aot_compile_s": delta_aot["compile_s"],
        "delta_aot_error": delta_aot["error"],
        "ring_lookup_qps": round(ring_qps, 0),
        "serve_lookup_qps": round(serve_qps, 0),
        **transport,
        "view_checksum_s": round(checksum_s, 4),
        "view_checksum_sum": int(cs_np.astype(np.uint64).sum() % 2**32),
        "view_checksum_sha256": hashlib.sha256(cs_np.tobytes()).hexdigest(),
        "lifecycle_final_digests": life_digests,
        "delta_final_digests": delta_digests,
        "rng": rng,
        "runs": runs,
        "platform": dev.type,
        "device_name": _device_name(dev),
        "compile_cache_dir": str(_cuda_build.build_dir()) if dev.type == "cuda" else None,
    }


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--rng", default="threefry", choices=("threefry", "counter"))
    ap.add_argument("--runs", type=int, default=3, help="timed detection and delta runs")
    args = ap.parse_args(argv)
    record = run_bench(args.device, args.rng, bool(os.environ.get("BENCH_FAST")), args.runs)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
