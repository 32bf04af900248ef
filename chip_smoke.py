#!/usr/bin/env python3
"""Smoke run of ringpop_tpu_torch on one CUDA card: the keyed-ownership path.

    python3 chip_smoke.py

Drives the PyTorch port's main path once, through the entry points a user
calls, at the scale of the ring benchmark (``BASELINE.json`` config 5: a
4096-server ring x 256 vnodes = 1,048,576 tokens, 1,048,576 keys):

1. build the Fingerprint32 kernel (``ringpop_tpu_torch/csrc/fingerprint32.cu``)
   and hold it bit-equal against its plain PyTorch version on the card and
   the numpy farm copy on the host, over every key length 0-130 (random
   bytes, >= 0x80 included), at widths that are not a multiple of 4 and
   batch sizes that are not a multiple of 32;
2. keyed lookup: hash 1,048,576 UUID-shaped 41-byte keys on the card and
   find their owners (``keyed_owner_lookup``) — owners equal a numpy
   searchsorted over the host hashes;
3. serve ring: a ``RingStore`` at capacity 2x the tokens answers
   ``serve_lookup_fused`` and ``serve_lookup_n_fused`` (n=3) against the host
   oracles, then a 1% churn commit (40 servers out, 40 in) is re-certified at
   generation 1, and the generation-0 snapshot still answers generation 0;
4. timings (CUDA events, medians, L2 flushed before each run) of the kernel,
   its plain version and the lookups, the card's name and power limit, one
   ``{"kernels": [...]}`` line, and the result line as the last line.

Exits non-zero, printing no result, on any failed check or when no CUDA
device is available.  Imports nothing of JAX or of ``ringpop_tpu``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ringpop_tpu_torch.hashing.farm import fingerprint32_batch, pack_strings
from ringpop_tpu_torch.ops import hash_kernel
from ringpop_tpu_torch.ops.hash_ops import fingerprint32_device, keyed_owner_lookup, upload_keys
from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens, host_lookup_n, ring_lookup
from ringpop_tpu_torch.serve.state import RingStore, serve_lookup_fused, serve_lookup_n_fused

SEED = 20261016
N_SERVERS = 4096
REPLICAS = 256
N_KEYS = 1 << 20
KEY_LEN = 41  # "trip:" + 8-4-4-4-12 hex
N_SAMPLE = 16_384  # keys checked against the host LookupN walk
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def uuid_keys(rng: np.random.Generator, n: int) -> tuple[np.ndarray, np.ndarray]:
    """n keys "trip:xxxxxxxx-xxxx-xxxx-xxxx-xxxxxxxxxxxx" packed as
    ``pack_strings`` would: uint8[n, 45], lens int64[n] = 41."""
    mat = np.zeros((n, KEY_LEN + 4), np.uint8)
    mat[:, :5] = np.frombuffer(b"trip:", np.uint8)
    hexd = np.frombuffer(b"0123456789abcdef", np.uint8)
    cols = [5 + i for i in range(36) if i not in (8, 13, 18, 23)]
    mat[:, cols] = hexd[rng.integers(0, 16, size=(n, 32))]
    mat[:, [5 + 8, 5 + 13, 5 + 18, 5 + 23]] = ord("-")
    return mat, np.full(n, KEY_LEN, np.int64)


def host_owner(tokens: np.ndarray, owners: np.ndarray, hashes: np.ndarray) -> np.ndarray:
    idx = np.searchsorted(tokens.astype(np.uint32), hashes.astype(np.uint32), side="left")
    idx[idx == tokens.shape[0]] = 0
    return owners[idx]


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median over ``reps`` runs of ``fn`` in ms (CUDA events), with the L2
    cache flushed before each run; one untimed warm-up run first."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase1_kernel_vs_plain(dev: torch.device) -> int:
    """Kernel == plain version == numpy copy over every length class."""
    t0 = time.perf_counter()
    lib = hash_kernel.build()
    log(f"phase1: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"phase1: ptxas: {line.strip()}")
    rng = np.random.default_rng(SEED)
    strings = [
        rng.integers(0, 256, size=length, dtype=np.uint8).tobytes()
        for length in range(131) for _ in range(64)
    ]
    lengths = np.array([len(s) for s in strings])
    max_err = 0
    # (longest key, extra zero columns, rows dropped from the end)
    for max_len, extra, drop in ((130, 0, 5), (41, 0, 7), (41, 2, 1), (24, 1, 3)):
        sub = [s for s, n in zip(strings, lengths) if n <= max_len][: -drop]
        mat, lens = pack_strings(sub)
        mat = np.pad(mat, ((0, 0), (0, extra)))
        b, w = mat.shape
        check(w % 4 != 0 and b % 32 != 0, f"corpus shape {b}x{w} is meant to be ragged")
        check(int((mat >= 0x80).sum()) > 0, "corpus holds bytes >= 0x80")
        want = fingerprint32_batch(mat, lens).astype(np.int64)
        dmat, dlens = upload_keys(mat, lens, dev)
        got = hash_kernel.fingerprint32_cuda(dmat, dlens)
        plain = fingerprint32_device(dmat, dlens)
        torch.cuda.synchronize()
        check(got.dtype == torch.int64 and got.shape == (b,), "kernel output int64[B]")
        max_err = max(max_err, int((got - plain).abs().max()))
        check(torch.equal(got, plain), f"kernel == plain at B={b} W={w}")
        check(np.array_equal(as_np(got), want), f"kernel == numpy farm at B={b} W={w}")
        log(f"phase1: B={b} W={w}: kernel == plain == numpy farm (tolerance: none, bit-equal)")
    return max_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, torch {torch.__version__}, cuda {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    kernels, timings = run(torch.device("cuda"), N_SERVERS, N_KEYS)
    timings["card"] = card
    log(json.dumps(timings))
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run(dev: torch.device, n_servers: int, n_keys: int) -> tuple[list, dict]:
    """Phases 1-4 on ``dev``; returns the kernels' records and the timings."""
    max_err = phase1_kernel_vs_plain(dev)

    # host-side set-up (not the device path): servers, keys, host oracles
    rng = np.random.default_rng(SEED + 1)
    servers = [f"10.0.{i // 256}.{i % 256}:3000" for i in range(n_servers)]
    mat, lens = uuid_keys(rng, n_keys)
    t0 = time.perf_counter()
    host_hashes = fingerprint32_batch(mat, lens)
    log(f"setup: numpy farm hashed {n_keys} keys in {time.perf_counter() - t0:.1f} s")
    sample = np.sort(rng.choice(n_keys, size=min(N_SAMPLE, n_keys), replace=False))
    dmat, dlens = upload_keys(mat, lens, dev)

    # -- the main path: launch counts are 0 before it and read right after --
    hash_kernel.launches = 0
    t0 = time.perf_counter()
    tokens, owners = build_ring_tokens(servers, REPLICAS, device=dev)
    check(tokens.shape[0] == n_servers * REPLICAS, f"ring holds {n_servers} x {REPLICAS} tokens")
    log(f"phase2: built the {tokens.shape[0]}-token ring in {time.perf_counter() - t0:.1f} s")
    got = keyed_owner_lookup(tokens, owners, dmat, dlens)
    want = host_owner(as_np(tokens), as_np(owners), host_hashes)
    check(np.array_equal(as_np(got), want), "keyed_owner_lookup owners == host searchsorted")
    check(hash_kernel.launches == 1, f"one kernel launch per keyed lookup, saw {hash_kernel.launches}")
    log(f"phase2: {n_keys} keys -> owners equal the host oracle")

    t0 = time.perf_counter()
    store = RingStore(servers, replica_points=REPLICAS, device=dev)
    check(store.capacity == 2 * n_servers * REPLICAS, "store capacity is 2x the tokens")
    log(f"phase3: RingStore built in {time.perf_counter() - t0:.1f} s, capacity {store.capacity}")
    hashes = hash_kernel.fingerprint32(dmat, dlens)
    check(np.array_equal(as_np(hashes), host_hashes.astype(np.int64)), "kernel hashes == numpy farm")

    def certify(ring, gen, host_tokens, host_owners, ns) -> None:
        fused = as_np(serve_lookup_fused(ring, hashes))
        check(fused.shape == (n_keys + 1,), "fused output is int32[B+1]")
        check(int(fused[-1]) == gen, f"fused tail slot holds generation {gen}")
        check(
            np.array_equal(fused[:-1], host_owner(host_tokens, host_owners, host_hashes)),
            f"serve_lookup_fused owners == host oracle at gen {gen}",
        )
        fused_n = as_np(serve_lookup_n_fused(ring, ns, hashes, 3))
        check(int(fused_n[-1]) == gen, f"LookupN tail slot holds generation {gen}")
        rows = fused_n[:-1].reshape(n_keys, 3)
        check((rows >= 0).all(), "every key has 3 owners")
        oracle = host_lookup_n(host_tokens, host_owners, host_hashes[sample], 3, ns)
        check(np.array_equal(rows[sample], oracle), f"serve_lookup_n_fused == host walk at gen {gen}")
        log(f"phase3: gen {gen}: fused owners and LookupN(3) rows equal the host oracles")

    ring0, gen0, ns0 = store.snapshot()
    ht0, ho0, _, _ = store.snapshot_host()
    certify(ring0, gen0, ht0, ho0, ns0)
    n_churn = max(1, n_servers // 100)
    added = [f"10.9.{i // 256}.{i % 256}:3000" for i in range(n_churn)]
    t0 = time.perf_counter()
    record = store.update(add=added, remove=servers[:n_churn])
    log(f"phase3: {n_churn}-server churn committed in {time.perf_counter() - t0:.2f} s: "
        f"gen {record['gen']}, {record['count']} tokens, reallocated {record['reallocated']}")
    ring1, gen1, ns1 = store.snapshot()
    ht1, ho1, _, _ = store.snapshot_host()
    check(gen1 == 1 and ns1 == n_servers, f"churn commit is generation 1 at {n_servers} servers")
    certify(ring1, gen1, ht1, ho1, ns1)
    old = as_np(serve_lookup_fused(ring0, hashes))
    check(int(old[-1]) == 0 and np.array_equal(old[:-1], host_owner(ht0, ho0, host_hashes)),
          "the generation-0 snapshot survives one commit")
    launches = hash_kernel.launches
    check(launches > 0, "the main path launched the Fingerprint32 kernel")
    log(f"main path: fingerprint32 launches = {launches}")

    # -- timings and the full-size kernel-vs-plain check (not counted) --
    plain = fingerprint32_device(dmat, dlens)
    max_err = max(max_err, int((hashes - plain).abs().max()))
    check(torch.equal(hashes, plain), "kernel == plain on the main path's keys")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    k_ms = time_ms(lambda: hash_kernel.fingerprint32_cuda(dmat, dlens), 20, flush)
    p_ms = time_ms(lambda: fingerprint32_device(dmat, dlens), 10, flush)
    keyed_ms = time_ms(lambda: keyed_owner_lookup(tokens, owners, dmat, dlens), 10, flush)
    lookup_ms = time_ms(lambda: ring_lookup(tokens, owners, hashes), 10, flush)
    serve_ms = time_ms(lambda: serve_lookup_fused(ring1, hashes), 10, flush)
    serve_n_ms = time_ms(lambda: serve_lookup_n_fused(ring1, ns1, hashes, 3), 10, flush)
    b, w = dmat.shape
    # bytes the kernel must move: key matrix + int32 lengths + uint32 hashes
    bound_ms = (b * w + 4 * b + 4 * b) / HBM_BYTES_PER_S * 1e3
    timings = {
        "timings_ms": {
            "fingerprint32_kernel": k_ms, "fingerprint32_plain": p_ms,
            "keyed_owner_lookup": keyed_ms, "ring_lookup": lookup_ms,
            "serve_lookup_fused": serve_ms, "serve_lookup_n_fused_n3": serve_n_ms,
        },
        "keys": b, "key_width": w, "ring_tokens": int(tokens.shape[0]),
        "keyed_lookup_keys_per_s": b / (keyed_ms / 1e3),
    }
    kernels = [{
        "name": "fingerprint32",
        "route": "cuda",
        "source": "ringpop_tpu_torch/csrc/fingerprint32.cu",
        "replaces": "ringpop_tpu/ops/hash_pallas.py:122",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]
    return kernels, timings


if __name__ == "__main__":
    sys.exit(main())
