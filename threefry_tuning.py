"""Time kernel T1 (``ringpop_tpu_torch/csrc/threefry.cu``) at several block
sizes and run lengths on the card.

    python3 threefry_tuning.py

builds the source once for each (threads a block, elements a thread) of
``CONFIGS`` (the macros ``RP_THREEFRY_THREADS`` and
``RP_THREEFRY_PER_THREAD``; one ``nvcc`` each, all at once), reads each
build's registers a thread from ``ptxas``'s report, and times the
headline's randint [1,000,000, 3] (span n) and the drop coin's uniform
[1,000,000] from each build: the kernel alone by ``torch.profiler`` after
a flush that leaves the L2 cache clean, the builds in turns (the list,
then back), each draw first checked bit-equal to its plain version.
Prints one JSON line with the card's name and power limit.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke
from ringpop_tpu_torch.ops import threefry_kernel
from ringpop_tpu_torch.sim import prng, threefry

CONFIGS = ((128, 8), (64, 8), (256, 8), (128, 4), (256, 4), (512, 4))
N = 1_000_000
SEED = 0


def draw(lib: ctypes.CDLL, key: torch.Tensor, kind: str, shape: tuple[int, ...], *bounds) -> torch.Tensor:
    """One draw from the library ``lib``, as ``ops/threefry_kernel.py``
    launches it: randint for int32 ``bounds`` (lo, hi), or uniform [0, 1)."""
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "randint":
        lo, hi = bounds
        span, mult, two_streams, (magic, add, shift1, shift2) = threefry_kernel.randint_variant(lo, hi)
        out = torch.empty(shape, dtype=torch.int32, device=key.device)
        err = lib.rp_threefry_randint(key.data_ptr(), out.numel(), lo, span, mult, two_streams, magic, add, shift1,
                                      shift2, out.data_ptr(), stream)
    else:
        out = torch.empty(shape, dtype=torch.float32, device=key.device)
        err = lib.rp_threefry_uniform(key.data_ptr(), out.numel(), ctypes.c_float(0.0), ctypes.c_float(1.0),
                                      out.data_ptr(), stream)
    chip_smoke.check(err == 0, f"threefry {kind} launch: cudaError {err}")
    return out


def time_builds(libs: dict[str, Path], draws: dict[str, tuple], dev: torch.device) -> dict[str, dict]:
    """Kernel-alone µs of each draw ``{name: (kind, shape, *bounds)}`` from
    each library of ``libs``, the libraries in turns (in order, then back),
    each draw first checked == plain."""
    key = prng.prng_key(SEED, dev)
    buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clean = lambda: buf.sum(dtype=torch.int64)  # noqa: E731
    plain = {name: (threefry.randint_plain(key, shape, *bounds) if kind == "randint" else
                    threefry.uniform_plain(key, shape)) for name, (kind, shape, *bounds) in draws.items()}
    loaded = {label: threefry_kernel.load(path) for label, path in libs.items()}
    out = {label: {} for label in libs}
    for label in [*libs, *reversed(libs)]:
        for name, (kind, shape, *bounds) in draws.items():
            fn = lambda: draw(loaded[label], key, kind, shape, *bounds)  # noqa: E731
            chip_smoke.check(torch.equal(fn(), plain[name]), f"T1 {label}: {name} == plain")
            found = chip_smoke.profile_ms(fn, 20, clean, "reduce_kernel")
            ms = chip_smoke.one_kernel_ms(found, chip_smoke.T1_KERNELS[kind])
            out[label].setdefault(f"{name}_us", []).append(ms * 1e3)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("threefry_tuning: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    defines = {f"{t}x{p}": (f"RP_THREEFRY_THREADS={t}", f"RP_THREEFRY_PER_THREAD={p}") for t, p in CONFIGS}
    with ThreadPoolExecutor(len(defines)) as ex:
        libs = dict(zip(defines, ex.map(threefry_kernel.build, defines.values())))
    draws = {"randint_n_by_3": ("randint", (N, 3), 0, N), "uniform_n": ("uniform", (N,))}
    times = time_builds(libs, draws, torch.device("cuda"))
    result = {label: {"registers": chip_smoke.ptxas_registers(lib, chip_smoke.t1_kernel_of), **times[label]}
              for label, lib in libs.items()}
    for label, rec in result.items():
        chip_smoke.log(f"tuning: T1 at {label} (threads x elements): {rec}")
    print(json.dumps({"card": card, "t1_tuning": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
