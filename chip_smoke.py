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
   batch sizes that are not a multiple of 32, at key matrices whose base is
   not 16-byte aligned (storage offsets 1, 3, 5, 7, 15), B = 1 and 257,
   W = 64 and 128 (the bank-conflict widths), int64 lengths, and W = 8200,
   which takes the kernel's wide route;
2. keyed lookup: hash 1,048,576 UUID-shaped 41-byte keys on the card and
   find their owners (``keyed_owner_lookup``) — owners equal a numpy
   searchsorted over the host hashes;
3. serve ring: a ``RingStore`` at capacity 2x the tokens answers
   ``serve_lookup_fused`` and ``serve_lookup_n_fused`` (n=3) against the host
   oracles, then a 1% churn commit (40 servers out, 40 in) is re-certified at
   generation 1, and the generation-0 snapshot still answers generation 0;
4. timings (CUDA events, medians, L2 flushed before each run) of the kernel's
   wrapper, its plain version and the lookups; the kernel alone by name from
   ``torch.profiler`` at 1,048,576 keys x W = 45, 64 and 128, beside its
   byte bound; the card's name and power limit, one ``{"kernels": [...]}``
   line, and the result line as the last line.

``python3 chip_smoke.py --kernel-profile`` runs step 4's kernel profile
alone and prints it as one JSON line: run from another checkout's root it
measures that checkout's kernel, so two versions can be compared on one
card in one run of the chip machine.

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


def profile_ms(fn, reps: int, flush, flush_tag: str) -> dict[str, tuple[int, float]]:
    """Device time of each kernel that ``fn`` launches, by kernel name, from
    ``torch.profiler`` over ``reps`` runs with ``flush()`` (which evicts the
    L2 cache) before each, after one untimed warm-up run: {name: (launches,
    mean ms per launch)}.  The flush's own kernels, named with
    ``flush_tag``, are left out.  A profile whose record misses a flush or
    a launch (the profiler can drop device records) is run again, twice at
    most."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        flush_kernels = 0
        found = {}
        for evt in prof.key_averages():
            us = evt.self_device_time_total
            # device activities that are not kernels (CUPTI's buffer
            # requests, module loading) carry no signature
            if evt.device_type != torch.autograd.DeviceType.CUDA or us <= 0 or "(" not in evt.key:
                continue
            if flush_tag in evt.key:
                flush_kernels += evt.count
                continue
            found[evt.key] = (evt.count, us / evt.count / 1e3)
        if flush_kernels >= reps and all(n % reps == 0 for n, _ in found.values()):
            return found
        log(f"profile: the profiler recorded {flush_kernels} of {reps} flushes and "
            f"{[n for n, _ in found.values()]} launches; profiling again")
    raise SystemExit(f"chip_smoke FAILED: profiler saw {flush_kernels} of the {reps} flushes")


def kernel_alone(found: dict[str, tuple[int, float]], reps: int) -> tuple[float, float]:
    """(Fingerprint32 kernel's mean ms per launch, the other kernels' ms per
    call) from :func:`profile_ms`'s record of ``reps`` wrapper calls."""
    fp = [(n, ms) for name, (n, ms) in found.items() if "fingerprint32" in name]
    check(len(fp) == 1 and fp[0][0] == reps,
          f"profiler shows the Fingerprint32 kernel once per call: {sorted(found)}")
    others = sum(n * ms for name, (n, ms) in found.items() if "fingerprint32" not in name)
    return fp[0][1], others / reps


def random_keys(rng: np.random.Generator, n: int, width: int) -> tuple[np.ndarray, np.ndarray]:
    """n random-byte keys of length width-4, packed as ``pack_strings``
    would: uint8[n, width] with 4 zero bytes after each key."""
    mat = np.zeros((n, width), np.uint8)
    mat[:, : width - 4] = rng.integers(0, 256, size=(n, width - 4), dtype=np.uint8)
    return mat, np.full(n, width - 4, np.int64)


def kernel_profile(dev: torch.device, widths=(45, 64, 128), n_keys: int = N_KEYS) -> dict:
    """The Fingerprint32 wrapper at n_keys x W for each W: its kernel alone
    (profiler) and the whole wrapper call (CUDA events), with the byte
    bound (key matrix + int32 lengths + int64 hashes) and the share of it.
    W = 45 hashes the main path's UUID keys, other widths random bytes.

    The L2 cache is flushed before each run as ``time_ms`` does, by zeroing
    a 256 MiB buffer, which leaves the L2 full of dirty lines that the
    kernel's reads then evict to device memory; the kernel alone is also
    timed after a flush that reads the buffer (clean lines, evicted for
    free), which charges it with its own bytes only."""
    rng = np.random.default_rng(SEED + 2)
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    dirty, clean = buf.zero_, lambda: buf.sum(dtype=torch.int64)
    out = {}
    for w in widths:
        mat, lens = uuid_keys(rng, n_keys) if w == KEY_LEN + 4 else random_keys(rng, n_keys, w)
        dmat, dlens = upload_keys(mat, lens, dev)
        fn = lambda: hash_kernel.fingerprint32_cuda(dmat, dlens)  # noqa: E731
        found = profile_ms(fn, 20, dirty, "FillFunctor")
        k_ms, other_ms = kernel_alone(found, 20)
        clean_ms, _ = kernel_alone(profile_ms(fn, 20, clean, "reduce_kernel"), 20)
        bound_ms = (n_keys * w + 4 * n_keys + 8 * n_keys) / HBM_BYTES_PER_S * 1e3
        rec = out[str(w)] = {
            "kernel_ms": k_ms, "kernel_ms_clean_l2": clean_ms, "other_kernels_ms": other_ms,
            "call_ms": time_ms(fn, 20, buf), "bound_ms": bound_ms,
            "share_of_bound": bound_ms / k_ms, "share_of_bound_clean_l2": bound_ms / clean_ms,
            "kernels": {name: {"launches": n, "ms": ms} for name, (n, ms) in found.items()},
        }
        log(f"profile: B={n_keys} W={w}: kernel alone {k_ms * 1e3:.2f} us "
            f"({clean_ms * 1e3:.2f} us after a clean flush), other kernels "
            f"{other_ms * 1e3:.2f} us, call {rec['call_ms'] * 1e3:.2f} us, bound "
            f"{bound_ms * 1e3:.2f} us ({bound_ms / k_ms:.1%}; {bound_ms / clean_ms:.1%})")
    return out


def check_case(dmat: torch.Tensor, dlens: torch.Tensor, mat: np.ndarray, lens: np.ndarray,
               what: str) -> int:
    """The kernel == the plain version on the card == the numpy farm on the
    host, bit for bit, for one key matrix; returns the max abs difference."""
    want = fingerprint32_batch(mat, lens).astype(np.int64)
    got = hash_kernel.fingerprint32_cuda(dmat, dlens)
    plain = fingerprint32_device(dmat, dlens)
    torch.cuda.synchronize()
    b, w = dmat.shape
    check(got.dtype == torch.int64 and got.shape == (b,), f"kernel output int64[B] ({what})")
    err = int((got - plain).abs().max()) if b else 0
    check(torch.equal(got, plain), f"kernel == plain at B={b} W={w} ({what})")
    check(np.array_equal(as_np(got), want), f"kernel == numpy farm at B={b} W={w} ({what})")
    log(f"phase1: B={b} W={w} {what}: kernel == plain == numpy farm (tolerance: none, bit-equal)")
    return err


def random_strings(rng: np.random.Generator, n: int, max_len: int) -> tuple[np.ndarray, np.ndarray]:
    """n random-byte strings of random lengths 0..max_len (max_len once),
    packed: uint8[n, max_len + 4]."""
    lengths = rng.integers(0, max_len + 1, size=n)
    lengths[0] = max_len
    return pack_strings([rng.integers(0, 256, size=n_, dtype=np.uint8).tobytes() for n_ in lengths])


def at_offset(dmat: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``dmat`` that starts ``offset`` bytes into its
    storage, so its base is not 16-byte aligned for offset % 16 != 0."""
    b, w = dmat.shape
    flat = torch.zeros(b * w + 32, dtype=torch.uint8, device=dmat.device)
    view = flat[offset: offset + b * w].view(b, w)
    view.copy_(dmat)
    check(view.is_contiguous() and view.data_ptr() % 16 == offset % 16, "offset view")
    return view


def phase1_kernel_vs_plain(dev: torch.device) -> int:
    """Kernel == plain version == numpy copy over every length class, ragged
    B and W, bases that are not 16-byte aligned, the bank-conflict widths,
    int64 lengths and the wide route."""
    t0 = time.perf_counter()
    lib = hash_kernel.build()
    log(f"phase1: built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
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
        dmat, dlens = upload_keys(mat, lens, dev)
        max_err = max(max_err, check_case(dmat, dlens, mat, lens, "corpus"))
        if (max_len, extra) == (41, 0):
            uuid_case = (mat, lens, dmat, dlens)

    mat, lens, dmat, dlens = uuid_case
    for offset in (1, 7, 15):
        max_err = max(max_err, check_case(at_offset(dmat, offset), dlens, mat, lens,
                                          f"base at storage offset {offset}"))
    for b in (1, 257):
        max_err = max(max_err, check_case(dmat[:b], dlens[:b], mat[:b], lens[:b], f"B={b}"))
        max_err = max(max_err, check_case(at_offset(dmat[:b], 3), dlens[:b], mat[:b], lens[:b],
                                          f"B={b}, base at storage offset 3"))
    max_err = max(max_err, check_case(dmat, dlens.to(torch.int64), mat, lens, "int64 lens"))
    for w in (64, 128):
        mat, lens = random_strings(rng, 3001, w - 4)
        dmat, dlens = upload_keys(mat, lens, dev)
        rows, stages, smem, route = hash_kernel.plan_tiles(w)
        check(route == "staged", f"W={w} takes the staged route")
        what = f"{rows} rows x {stages} stages, pad_shift {hash_kernel.pad_shift(w)}"
        max_err = max(max_err, check_case(dmat, dlens, mat, lens, what))
        max_err = max(max_err, check_case(at_offset(dmat, 7), dlens.to(torch.int64), mat, lens,
                                          "int64 lens, base at storage offset 7"))
    # wide route: not even a 32-row stage fits in shared memory
    mat, lens = random_strings(rng, 67, 8196)
    check(hash_kernel.plan_tiles(mat.shape[1])[3] == "wide", "W=8200 takes the wide route")
    dmat, dlens = upload_keys(mat, lens, dev)
    wide_before = hash_kernel.route_launches["wide"]
    max_err = max(max_err, check_case(dmat, dlens, mat, lens, "wide route"))
    max_err = max(max_err, check_case(at_offset(dmat, 5), dlens.to(torch.int64), mat, lens,
                                      "wide route, int64 lens, base at storage offset 5"))
    check(hash_kernel.route_launches["wide"] == wide_before + 2, "the wide route launched")
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
    if sys.argv[1:] == ["--kernel-profile"]:
        log(json.dumps({"card": card, "profile": kernel_profile(torch.device("cuda"))}))
        return 0
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
    hash_kernel.reset_launches()
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
    by_route = dict(hash_kernel.route_launches)
    check(launches > 0 and by_route["staged"] == launches,
          f"the main path launched the staged Fingerprint32 kernel: {by_route}")
    log(f"main path: fingerprint32 launches = {launches} {by_route}")

    # -- timings and the full-size kernel-vs-plain check (not counted) --
    plain = fingerprint32_device(dmat, dlens)
    max_err = max(max_err, int((hashes - plain).abs().max()))
    check(torch.equal(hashes, plain), "kernel == plain on the main path's keys")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    p_ms = time_ms(lambda: fingerprint32_device(dmat, dlens), 10, flush)
    keyed_ms = time_ms(lambda: keyed_owner_lookup(tokens, owners, dmat, dlens), 10, flush)
    lookup_ms = time_ms(lambda: ring_lookup(tokens, owners, hashes), 10, flush)
    serve_ms = time_ms(lambda: serve_lookup_fused(ring1, hashes), 10, flush)
    serve_n_ms = time_ms(lambda: serve_lookup_n_fused(ring1, ns1, hashes, 3), 10, flush)
    del flush
    profile = kernel_profile(dev)
    main = profile[str(dmat.shape[1])]
    timings = {
        "timings_ms": {
            "fingerprint32_kernel_alone": main["kernel_ms"],
            "fingerprint32_call": main["call_ms"], "fingerprint32_plain": p_ms,
            "keyed_owner_lookup": keyed_ms, "ring_lookup": lookup_ms,
            "serve_lookup_fused": serve_ms, "serve_lookup_n_fused_n3": serve_n_ms,
        },
        "keys": n_keys, "key_width": int(dmat.shape[1]), "ring_tokens": int(tokens.shape[0]),
        "keyed_lookup_keys_per_s": n_keys / (keyed_ms / 1e3),
    }
    kernels = [{
        "name": "fingerprint32",
        "route": "cuda",
        "source": "ringpop_tpu_torch/csrc/fingerprint32.cu",
        "replaces": "ringpop_tpu/ops/hash_pallas.py:122",
        "launches": launches,
        "launches_by_route": by_route,
        "max_abs_err": max_err,
        "ms": main["kernel_ms"],
        "call_ms": main["call_ms"],
        "plain_ms": p_ms,
        "bound_ms": main["bound_ms"],
        "share_of_bound": main["share_of_bound"],
        "bound_by": "bytes",
        "library_ms": None,
        "by_width": {w: {k: v for k, v in rec.items() if k != "kernels"}
                     for w, rec in profile.items()},
    }]
    return kernels, timings


if __name__ == "__main__":
    sys.exit(main())
