"""The Fingerprint32 kernel for Hopper: build, bind and launch.

Replaces ``ringpop_tpu/ops/hash_pallas.py`` (``fingerprint32_pallas`` and its
``_mix_kernel``).  The kernel, ``csrc/fingerprint32.cu``, is CUDA C++ for
``sm_90a`` with a plain C entry point: it is compiled with ``nvcc`` at first
use into ``ringpop_tpu_torch/_build/`` (keyed by a hash of the source and the
flags, so an edited source rebuilds; ``ops/_cuda_build.py``) and loaded with
ctypes.  Nothing is
built or loaded when this module is imported.

:func:`fingerprint32` follows its input's device: a CPU tensor takes the plain
PyTorch version (``hash_ops.fingerprint32_device``), a CUDA tensor takes the
kernel — or raises.  There is no fallback from the kernel to the plain
version and no per-width verdict cache: the JAX package guards its kernel
because Mosaic may refuse to lower it, and ``nvcc`` either builds this one
or the build fails loudly.

The kernel has two routes, chosen by the key width in :func:`plan_tiles`:
``staged`` (tiles of rows copied into shared memory, the design for every
key width a ring sees) and ``wide`` (rows hashed straight from device
memory, for widths where not even a 32-row tile fits in shared memory).
``route_launches`` counts the launches of each route and ``launches``
their sum (one per :func:`fingerprint32_cuda` call that reaches the card),
so a run can show its main path went through the kernel;
:func:`reset_launches` sets all of them to 0.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ringpop_tpu_torch.ops import _cuda_build
from ringpop_tpu_torch.ops.hash_ops import check_key_matrix, fingerprint32_device

SOURCE = _cuda_build.CSRC / "fingerprint32.cu"
BUILD_DIR: Optional[Path] = None  # None: _cuda_build.build_dir(), the configured build cache

SMEM_BUDGET = 232_448  # dynamic shared memory one block may use on Hopper (227 KB)
MAX_ROWS_PER_TILE = 256  # rows of a tile = threads of a block
NO_PAD = 24  # pad_shift that puts no pad inside any stage
BANKS = 32

launches = 0
route_launches = {"staged": 0, "wide": 0}

_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """Compile ``csrc/fingerprint32.cu`` unless the library for this source
    is already built (``_cuda_build.build``).  Raises RuntimeError on
    failure."""
    return _cuda_build.build(SOURCE, BUILD_DIR)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.rp_fingerprint32_staged.argtypes = [
                ptr, ptr, i32, ptr, i64, i32, i32, i32, i32, i32, ptr,
            ]
            lib.rp_fingerprint32_wide.argtypes = [ptr, ptr, i32, ptr, i64, i32, ptr]
            lib.rp_fingerprint32_staged.restype = i32
            lib.rp_fingerprint32_wide.restype = i32
            _lib = lib
        return _lib


def reset_launches() -> None:
    """Set ``launches`` and every route's count to 0."""
    global launches
    launches = 0
    for route in route_launches:
        route_launches[route] = 0


@lru_cache(maxsize=None)
def bank_conflicts(width: int, shift: int) -> int:
    """Worst bank conflict of one warp's shared-memory word loads: 32
    consecutive rows of ``width`` bytes, staged with a 16-byte pad after
    every 2**shift 16-byte chunks, each thread reading the aligned word at
    the same byte offset of its row (offsets 0 .. 60 taken)."""
    offsets = np.arange(0, min(width - 4, 60) + 1, 4)
    k = (np.arange(BANKS)[:, None] * width + offsets[None, :]) >> 2  # logical words
    banks = (k + (((k >> 2) >> shift) << 2)) % BANKS
    return int((banks[:, :, None] == np.arange(BANKS)).sum(axis=0).max())


@lru_cache(maxsize=None)
def pad_shift(width: int) -> int:
    """The skew of a staged tile: a 16-byte pad after every 2**shift chunks
    of 16 bytes, shift in 3..8 (at most 1/8 of the stage is pad) or NO_PAD,
    whichever spreads a warp's rows over the most banks (the least padding
    on a tie).  Rows of a width that is a multiple of 16 start in one of
    only 8 slots of a 128-byte line without it (32-way conflicts at W = 128,
    16-way at W = 64)."""
    return min((NO_PAD, *range(8, 2, -1)), key=lambda s: (bank_conflicts(width, s), -s))


def stage_bytes(rows: int, width: int, shift: int) -> int:
    """Shared memory for one staged tile of ``rows`` rows: the span's 16-byte
    chunks, one more for a base that is not 16-byte aligned and one for the
    aligned word read past a row's last byte, plus the skew's pads."""
    chunks = rows * width // 16 + 2
    return 16 * (chunks + ((chunks - 1) >> shift))


def plan_tiles(width: int, smem_budget: int = SMEM_BUDGET) -> tuple[int, int, int, str]:
    """(rows_per_tile, stages, smem_bytes, route) for keys of ``width``
    bytes: the most rows (a multiple of 32, at most 256) whose ring of two
    stages fits ``smem_budget``; else the most rows of one stage that
    fits; else the ``wide`` route (0, 0, 0, "wide"), which stages nothing —
    exactly where a 32-row stage does not fit."""
    shift = pad_shift(width)
    for stages in (2, 1):
        for rows in range(MAX_ROWS_PER_TILE, 31, -32):
            smem = stages * stage_bytes(rows, width, shift)
            if smem <= smem_budget:
                return rows, stages, smem, "staged"
    return 0, 0, 0, "wide"


def fingerprint32_cuda(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: uint8[B, W] CUDA key matrix + lengths -> int64[B]
    holding each uint32 Fingerprint32.  Raises ValueError for a tensor that
    is not on the card and RuntimeError when the kernel cannot be built or
    its launch is refused."""
    global launches
    check_key_matrix(mat, lens)
    if not mat.is_cuda:
        raise ValueError(f"fingerprint32_cuda needs CUDA tensors, got {mat.device}")
    if not mat.is_contiguous():
        raise ValueError("key matrix must be contiguous")
    lens = lens.contiguous()
    rows, width = mat.shape
    # the kernel writes each uint32 hash zero-extended: no hash >= 2**31
    # ever reaches a comparison as int32
    out = torch.empty(rows, dtype=torch.int64, device=mat.device)
    lib = _library()
    if rows:
        rows_per_tile, stages, smem, route = plan_tiles(width)
        lens64 = int(lens.dtype == torch.int64)
        with torch.cuda.device(mat.device):
            stream = torch.cuda.current_stream().cuda_stream
            if route == "staged":
                err = lib.rp_fingerprint32_staged(
                    mat.data_ptr(), lens.data_ptr(), lens64, out.data_ptr(), rows, width,
                    rows_per_tile, stages, smem, pad_shift(width), stream,
                )
            else:
                err = lib.rp_fingerprint32_wide(
                    mat.data_ptr(), lens.data_ptr(), lens64, out.data_ptr(), rows, width, stream
                )
        if err != 0:
            raise RuntimeError(f"fingerprint32 kernel ({route}) launch failed: cudaError {err}")
        route_launches[route] += 1
        launches += 1
    return out


def fingerprint32(mat: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Fingerprint32 of each key row, int64[B] on the input's device: the
    plain PyTorch version for CPU tensors, the kernel for CUDA tensors."""
    if mat.device.type == "cpu":
        return fingerprint32_device(mat, lens)
    return fingerprint32_cuda(mat, lens)
