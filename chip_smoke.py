#!/usr/bin/env python3
"""Smoke run of ringpop_tpu_torch on one CUDA card: the keyed-ownership path
and the SWIM dissemination engine.

    python3 chip_smoke.py

Drives the PyTorch port's main paths once, through the entry points a user
calls: the keyed path at the scale of the ring benchmark (``BASELINE.json``
config 5: a 4096-server ring x 256 vnodes = 1,048,576 tokens, 1,048,576
keys), and the delta engine at ``bench.py``'s delta configuration
(1,000,000 nodes x 128 rumor slots):

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
   line, and the result line as the last line;
5. build the packed-plane kernels (``ringpop_tpu_torch/csrc/packbits.cu``)
   and hold the bitwise row reduce (OR and AND) and the row popcount
   bit-equal against their plain PyTorch versions on the card, at
   N = 1, 31, 33, 4097, 1,000,000 x W = 1, 2, 3, 4, 8 (planes packed from
   K = 32W - 5 slots, so the tail bits are zero), sparse, dense and random
   planes, with no row mask, a random one, an all-false and an all-true
   one, at a base that is not 16-byte aligned and at W = 1032 (wider than
   one block's column tile); then each kernel alone
   by name from ``torch.profiler`` at the delta path's shapes, beside its
   byte bound;
6. the delta engine at 1,000,000 x 128, ``exchange="shift"``,
   ``rng="counter"``, from ``init_state(seed=1)``: the first 8 ticks on the
   kernels and, side by side, with the plain reduces on the card, every leaf
   equal at every tick; then ``run_until_converged(max_ticks=4096,
   check_every=8)`` converges in the tick count of the JAX package (pinned
   below, from a CPU run of ``ringpop_tpu``) with the sha256 of every final
   leaf equal to the pinned JAX digests; its wall time (CUDA events) and a
   ``torch.profiler`` breakdown of one 8-tick block by kernel and by phase,
   with the device's busy share of the window;
7. the uniform exchange with faults at 1,000,000 x 128: 1000 nodes down,
   ``drop_rate=0.01``, 24 ticks from ``seed=1``; the final leaves' digests
   equal the pinned JAX ones.

``python3 chip_smoke.py --kernel-profile`` runs step 4's kernel profile
alone and prints it as one JSON line: run from another checkout's root it
measures that checkout's kernel, so two versions can be compared on one
card in one run of the chip machine.

Exits non-zero, printing no result, on any failed check or when no CUDA
device is available.  Imports nothing of JAX or of ``ringpop_tpu``.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ringpop_tpu_torch.hashing.farm import fingerprint32_batch, pack_strings
from ringpop_tpu_torch.ops import hash_kernel, packbits_kernel
from ringpop_tpu_torch.ops.hash_ops import fingerprint32_device, keyed_owner_lookup, upload_keys
from ringpop_tpu_torch.ops.ring_ops import build_ring_tokens, host_lookup_n, ring_lookup
from ringpop_tpu_torch.serve.state import RingStore, serve_lookup_fused, serve_lookup_n_fused
from ringpop_tpu_torch.sim import delta, packbits

SEED = 20261016
N_SERVERS = 4096
REPLICAS = 256
N_KEYS = 1 << 20
KEY_LEN = 41  # "trip:" + 8-4-4-4-12 hex
N_SAMPLE = 16_384  # keys checked against the host LookupN walk
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)

# the delta engine's configuration: bench.py's delta run (bench.py:414, 546)
DELTA_N, DELTA_K, DELTA_SEED = 1_000_000, 128, 1
DELTA_MAX_TICKS, DELTA_CHECK_EVERY = 4096, 8
PACKBITS_ROWS = (1, 31, 33, 4097, 1_000_000)
PACKBITS_WIDTHS = (1, 2, 3, 4, 8)
# pinned from the JAX package (ringpop_tpu.sim.delta, rng="counter") run on
# the CPU; tests/test_torch_chip_smoke_pins.py recomputes them
PIN_SHIFT_TICKS = 16
PIN_SHIFT = {
    "learned": "d1862c53f4fa3daac39b7969f32c448cd7af87ee59a42fb6dd567fc4be68d3ea",
    "pcount": "4238245cc664c2d3197e49baed50a2c5f05323f54644b110ff126943b0fe444a",
    "ride_ok": "d1862c53f4fa3daac39b7969f32c448cd7af87ee59a42fb6dd567fc4be68d3ea",
    "tick": "097328e8c957de2428283954f6a1ee8ff7ad7def12e100a600178407f5decf24",
    "key": "01acecb507abfe1a354aa8064f4af5d3f1acd019e37db3c11c97523b71c76e9d",
}
UNIFORM_TICKS, UNIFORM_DOWN, UNIFORM_DOWN_SEED, UNIFORM_DROP = 24, 1000, 0, 0.01
PIN_UNIFORM = {
    "learned": "2a2ab808e0ccb06a78a9b17715d5cf7aa750454519ce1e1a7d56cc86250f87e6",
    "pcount": "2965581ccdfe0a0ab16dc78b0f4023cfba89c207417391dbc6755fa7eec1b426",
    "ride_ok": "d1862c53f4fa3daac39b7969f32c448cd7af87ee59a42fb6dd567fc4be68d3ea",
    "tick": "17fa9c7f5e9039a2d46e73e17d8e094a796ee4c313199bad42db4ee1dc30d865",
    "key": "01acecb507abfe1a354aa8064f4af5d3f1acd019e37db3c11c97523b71c76e9d",
}


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


# -- the delta engine: packed-plane kernels and the SWIM dissemination path --


def leaf_digests(leaves) -> dict[str, str]:
    """sha256 of each ``DeltaState`` leaf (numpy, in the JAX package's
    dtypes: uint32 planes and key, int8 pcount, int32 tick) over its
    little-endian bytes."""
    out = {}
    for name, leaf in zip(delta.DeltaState._fields, leaves):
        arr = np.ascontiguousarray(np.asarray(leaf))
        out[name] = hashlib.sha256(arr.astype(arr.dtype.newbyteorder("<")).tobytes()).hexdigest()
    return out


def uniform_down_nodes(n: int) -> np.ndarray:
    """The nodes that are down in phase 7's configuration."""
    return np.random.default_rng(UNIFORM_DOWN_SEED).choice(n, UNIFORM_DOWN, replace=False)


def reduce_plain(p: torch.Tensor, op: str, rows=None) -> torch.Tensor:
    fn = packbits.or_reduce_rows_plain if op == "or" else packbits.and_reduce_rows_plain
    return fn(p, rows)


@contextlib.contextmanager
def plain_packbits():
    """Route ``sim/packbits``'s reduces and popcount on CUDA tensors to their
    plain versions (on the card) for the duration: the delta path with no
    kernel of this slice."""
    saved = packbits_kernel.reduce_rows_cuda, packbits_kernel.popcount_rows_cuda
    packbits_kernel.reduce_rows_cuda = reduce_plain
    packbits_kernel.popcount_rows_cuda = packbits.popcount_rows_plain
    try:
        yield
    finally:
        packbits_kernel.reduce_rows_cuda, packbits_kernel.popcount_rows_cuda = saved


def random_plane(gen: torch.Generator, n: int, w: int, kind: str, dev) -> torch.Tensor:
    """int32[n, w] plane packed from K = 32w - 5 slots (tail bits zero):
    ``sparse`` bits (a column's OR is 0 with probability 1/2), ``dense``
    bits (a column's AND is 1 with probability 1/2) or ``random`` (p = 1/2)."""
    k = 32 * w - 5
    q = 1.0 - 0.5 ** (1.0 / n)
    density = {"sparse": q, "dense": 1.0 - q, "random": 0.5}[kind]
    return packbits.pack_bool(torch.rand((n, k), generator=gen, device=dev) < density)


def check_packbits_case(p: torch.Tensor, rows, what: str) -> int:
    """S1 (OR and AND) and S2 == their plain versions on one plane; returns
    the max abs difference (of the int32 words)."""
    err = 0
    for op in ("or", "and"):
        got = packbits_kernel.reduce_rows_cuda(p, op, rows)
        want = reduce_plain(p, op, rows)
        err = max(err, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want), f"row reduce {op} == plain ({what})")
    if rows is None:
        got = packbits_kernel.popcount_rows_cuda(p)
        want = packbits.popcount_rows_plain(p)
        check(got.dtype == torch.int32 and got.shape == (p.shape[0],), f"popcount int32[N] ({what})")
        err = max(err, int((got - want).abs().max()))
        check(torch.equal(got, want), f"popcount == plain ({what})")
    return err


def phase5_packbits(dev: torch.device) -> int:
    """S1 and S2 bit-equal to their plain versions on the card; each
    wrapper's launch count checked.  Returns the max abs difference."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    packbits_kernel.reset_launches()
    calls = {"row_reduce": 0, "popcount_rows": 0}
    max_err = 0
    for n in PACKBITS_ROWS:
        for w in PACKBITS_WIDTHS:
            rows_rand = torch.rand(n, generator=gen, device=dev) < 0.5
            masks = {"no mask": None, "random mask": rows_rand,
                     "all-false mask": torch.zeros(n, dtype=torch.bool, device=dev),
                     "all-true mask": torch.ones(n, dtype=torch.bool, device=dev)}
            for kind in ("sparse", "dense", "random"):
                p = random_plane(gen, n, w, kind, dev)
                for mname, rows in masks.items():
                    max_err = max(max_err, check_packbits_case(p, rows, f"N={n} W={w} {kind}, {mname}"))
                    calls["row_reduce"] += 2
                    calls["popcount_rows"] += rows is None
            log(f"phase5: N={n} W={w}: row reduce OR/AND and popcount == plain "
                f"(3 planes x 4 masks; tolerance: none, bit-equal)")
    # a base 4 bytes past a 16-byte boundary (one-word loads), and a plane
    # wider than one block's 256 four-word columns (two column tiles)
    for n, w, offset in ((4097, 4, 1), (4097, 8, 1), (33, 1032, 0)):
        flat = random_plane(gen, n * w + offset, 1, "random", dev).reshape(-1)
        p = flat[offset:].view(n, w)
        vec = packbits_kernel.vec_words(w, p.data_ptr())
        check(vec == (1 if offset else 4), f"N={n} W={w} at +{4 * offset} bytes: {vec}-word loads")
        for mname, rows in (("no mask", None), ("random mask", torch.rand(n, generator=gen, device=dev) < 0.5)):
            what = f"N={n} W={w}, base at +{4 * offset} bytes, {mname}"
            max_err = max(max_err, check_packbits_case(p, rows, what))
            calls["row_reduce"] += 2
            calls["popcount_rows"] += rows is None
            log(f"phase5: {what}: == plain")
    torch.cuda.synchronize()
    check(packbits_kernel.launches == calls,
          f"one launch per wrapper call: {packbits_kernel.launches} vs {calls}")
    log(f"phase5: launches {packbits_kernel.launches}; max abs err {max_err}")
    return max_err


def packbits_profile(dev: torch.device) -> dict:
    """S1 and S2 alone (profiler, by name) at the delta path's shapes, after
    a flush that leaves the L2 cache clean, and after none (the tick's
    reduces read a plane it has just written); the wrapper calls and the
    plain versions by CUDA events; each beside its byte bound."""
    n, w = DELTA_N, packbits.n_words(DELTA_K)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    p = random_plane(gen, n, w, "random", dev)
    rows = torch.rand(n, generator=gen, device=dev) < 0.999
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clean = lambda: buf.sum(dtype=torch.int64)  # noqa: E731
    tiny = torch.empty(1, dtype=torch.int32, device=dev)  # a tagged no-op between warm runs
    cases = {
        "row_reduce_or": (lambda: packbits_kernel.reduce_rows_cuda(p, "or"),
                          lambda: reduce_plain(p, "or"), 4 * n * w + 4 * w),
        "row_reduce_and_masked": (lambda: packbits_kernel.reduce_rows_cuda(p, "and", rows),
                                  lambda: reduce_plain(p, "and", rows), 4 * n * w + n + 4 * w),
        "popcount_rows": (lambda: packbits_kernel.popcount_rows_cuda(p),
                          lambda: packbits.popcount_rows_plain(p), 4 * n * w + 4 * n),
    }
    out = {}
    for name, (fn, plain, nbytes) in cases.items():
        kname = "packbits_popcount_rows" if name == "popcount_rows" else "packbits_row_reduce"
        found = profile_ms(fn, 20, clean, "reduce_kernel")
        ms = [v[1] for key, v in found.items() if kname in key]
        check(len(ms) == 1, f"profiler shows {kname} once: {sorted(found)}")
        warm = profile_ms(fn, 20, tiny.zero_, "FillFunctor")
        warm_ms = [v[1] for key, v in warm.items() if kname in key]
        check(len(warm_ms) == 1, f"profiler shows {kname} once (warm): {sorted(warm)}")
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rec = out[name] = {
            "kernel_ms": ms[0], "kernel_ms_warm_l2": warm_ms[0],
            "call_ms": time_ms(fn, 20, buf), "plain_ms": time_ms(plain, 10, buf),
            "bound_ms": bound_ms, "share_of_bound": bound_ms / ms[0], "bytes": nbytes,
        }
        log(f"profile: {name} N={n} W={w}: kernel alone {ms[0] * 1e3:.2f} us after a clean "
            f"flush, {rec['kernel_ms_warm_l2'] * 1e3:.2f} us warm; call {rec['call_ms'] * 1e3:.2f} us; "
            f"plain {rec['plain_ms']:.4f} ms; bound {bound_ms * 1e3:.2f} us ({bound_ms / ms[0]:.1%})")
    return out


def delta_block_profile(params, state, faults, ticks: int) -> dict:
    """``torch.profiler`` over ``ticks`` ticks from ``state``: device time by
    kernel name (top 10) and by phase range, the window (CUDA events) and
    the device's busy share of it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ticks):
            state = delta.step(params, state, faults)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    kernels, phases, spans = {}, {}, {}
    for evt in prof.key_averages():
        on_device = evt.device_type == torch.autograd.DeviceType.CUDA
        if evt.key in delta.PHASES:
            # a range appears twice: on the host, with the device time of
            # the kernels it launched, and on the device, as the span from
            # its first kernel's start to its last one's end (gaps included)
            if on_device:
                spans[evt.key] = evt.self_device_time_total / 1e3
            else:
                phases[evt.key] = evt.device_time_total / 1e3
        elif on_device and evt.self_device_time_total > 0:
            kernels[evt.key] = (evt.count, evt.self_device_time_total / 1e3)
    busy_ms = sum(ms for _, ms in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "ticks": ticks, "window_ms": window_ms, "device_busy_ms": busy_ms,
        "busy_share": busy_ms / window_ms, "idle_share": 1.0 - busy_ms / window_ms,
        "kernel_launches": sum(c for c, _ in kernels.values()),
        "phases_kernel_ms": phases, "phases_span_ms": spans,
        "packbits_kernels": {name: {"launches": c, "ms": ms} for name, (c, ms) in kernels.items()
                             if "packbits_" in name},
        "top_kernels": [{"name": name[:160], "launches": c, "ms": ms} for name, (c, ms) in top],
    }


def phase6_delta_shift(dev: torch.device) -> dict:
    """The delta path at 1M x 128 (shift): kernels vs plain reduces for 8
    ticks, then the counted, timed convergence run against the JAX pins."""
    params = delta.DeltaParams(n=DELTA_N, k=DELTA_K, exchange="shift", rng="counter")
    t0 = time.perf_counter()
    a = delta.init_state(params, seed=DELTA_SEED, device=dev)
    b = a
    for t in range(8):
        a = delta.step(params, a)
        before = dict(packbits_kernel.launches)
        with plain_packbits():
            b = delta.step(params, b)
        check(packbits_kernel.launches == before, "the plain twin launched no kernel")
        for name, x, y in zip(delta.DeltaState._fields, a, b):
            check(torch.equal(x, y), f"tick {t + 1}: {name} on the kernels == on the plain reduces")
    torch.cuda.synchronize()
    log(f"phase6: 8 ticks at {DELTA_N} x {DELTA_K}: every leaf on the kernels == on the plain "
        f"reduces at every tick ({time.perf_counter() - t0:.1f} s with the warm-up)")

    # -- the main path: launch counts are 0 before it and read right after --
    walls = []
    for run_i in range(3):
        state0 = delta.init_state(params, seed=DELTA_SEED, device=dev)
        torch.cuda.synchronize()
        if run_i == 0:
            packbits_kernel.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, ticks, ok = delta.run_until_converged(
            params, state0, max_ticks=DELTA_MAX_TICKS, check_every=DELTA_CHECK_EVERY)
        end.record()
        torch.cuda.synchronize()
        walls.append(start.elapsed_time(end))
        if run_i == 0:
            frac = float(delta.converged_fraction(state))
            launches = dict(packbits_kernel.launches)
            final = state
    check(ok and ticks == PIN_SHIFT_TICKS, f"converged in {ticks} ticks (JAX: {PIN_SHIFT_TICKS})")
    check(frac == 1.0, f"converged_fraction {frac} == 1.0")
    digests = leaf_digests(delta.state_to_numpy(final))
    for name, want in PIN_SHIFT.items():
        check(digests[name] == want, f"final {name} digest == the JAX package's")
    blocks = PIN_SHIFT_TICKS // DELTA_CHECK_EVERY
    check(launches == {"row_reduce": 2 * PIN_SHIFT_TICKS + blocks + 1, "popcount_rows": 1},
          f"the delta path launched S1 twice a tick + once a check and S2 once: {launches}")
    log(f"phase6: converged in {ticks} ticks == JAX; final leaf digests == JAX; "
        f"launches {launches}; wall {[round(w, 3) for w in walls]} ms")
    profile = delta_block_profile(params, delta.init_state(params, seed=DELTA_SEED, device=dev),
                                  delta.DeltaFaults(), DELTA_CHECK_EVERY)
    log(f"phase6: one {DELTA_CHECK_EVERY}-tick block: window {profile['window_ms']:.3f} ms, device "
        f"busy {profile['device_busy_ms']:.3f} ms ({profile['busy_share']:.1%}), "
        f"{profile['kernel_launches']} kernel launches; kernel ms by phase {profile['phases_kernel_ms']}; "
        f"span ms by phase {profile['phases_span_ms']}; this slice's kernels {profile['packbits_kernels']}")
    for rec in profile["top_kernels"]:
        log(f"phase6:   {rec['ms']:.4f} ms  x{rec['launches']}  {rec['name'][:110]}")
    return {
        "launches": launches, "ticks": ticks, "converged_fraction": frac,
        "wall_ms": walls, "ms_per_tick": [w / ticks for w in walls], "block_profile": profile,
    }


def phase7_delta_uniform(dev: torch.device) -> dict:
    """The uniform exchange with 1000 nodes down and drop_rate 0.01 at
    1M x 128 for 24 ticks: final leaf digests == the JAX pins."""
    params = delta.DeltaParams(n=DELTA_N, k=DELTA_K, exchange="uniform", rng="counter")
    up = np.ones(DELTA_N, bool)
    up[uniform_down_nodes(DELTA_N)] = False
    faults = delta.DeltaFaults(up=torch.from_numpy(up).to(dev),
                               drop_rate=torch.tensor(UNIFORM_DROP, dtype=torch.float32, device=dev))
    state = delta.init_state(params, seed=DELTA_SEED, device=dev)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(UNIFORM_TICKS):
        state = delta.step(params, state, faults)
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    digests = leaf_digests(delta.state_to_numpy(state))
    for name, want in PIN_UNIFORM.items():
        check(digests[name] == want, f"uniform: final {name} digest == the JAX package's")
    frac = float(delta.converged_fraction(state, faults))
    check(frac == 1.0 and bool(delta.converged(state, faults)), f"uniform: converged ({frac})")
    log(f"phase7: uniform, {UNIFORM_DOWN} down, drop {UNIFORM_DROP}: {UNIFORM_TICKS} ticks in "
        f"{wall:.3f} ms; final leaf digests == JAX; converged")
    return {"ticks": UNIFORM_TICKS, "wall_ms": wall, "ms_per_tick": wall / UNIFORM_TICKS}


def run_delta(dev: torch.device) -> tuple[list, dict]:
    """Phases 5-7 on ``dev``; returns the kernels' records and the timings."""
    max_err = phase5_packbits(dev)
    prof = packbits_profile(dev)
    shift = phase6_delta_shift(dev)
    uniform = phase7_delta_uniform(dev)
    launches = shift["launches"]
    kernels = []
    for name, key, cases, line in (
        ("packbits_row_reduce", "row_reduce", ("row_reduce_or", "row_reduce_and_masked"),
         "ringpop_tpu/sim/packbits.py:181"),
        ("packbits_popcount_rows", "popcount_rows", ("popcount_rows",),
         "ringpop_tpu/sim/packbits.py:126"),
    ):
        rec = prof[cases[0]]  # the delta path's shape: no row mask
        kernels.append({
            "name": name, "route": "cuda", "source": "ringpop_tpu_torch/csrc/packbits.cu",
            "replaces": line, "launches": launches[key], "max_abs_err": max_err,
            "ms": rec["kernel_ms"], "ms_warm_l2": rec["kernel_ms_warm_l2"], "call_ms": rec["call_ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "share_of_bound": rec["share_of_bound"], "bound_by": "bytes", "library_ms": None,
            "by_case": {c: prof[c] for c in cases},
        })
    return kernels, {"delta_shift": shift, "delta_uniform": uniform}


def build_kernels() -> None:
    """Build every kernel source at once, one nvcc each."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        libs = list(ex.map(lambda m: m.build(), (hash_kernel, packbits_kernel)))
    log(f"build: {[lib.name for lib in libs]} in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"build: ptxas ({lib.stem.split('_')[0]}): {line.strip()}")


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
    build_kernels()
    kernels, timings = run(torch.device("cuda"), N_SERVERS, N_KEYS)
    delta_kernels, delta_timings = run_delta(torch.device("cuda"))
    kernels += delta_kernels
    timings.update(delta_timings)
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
