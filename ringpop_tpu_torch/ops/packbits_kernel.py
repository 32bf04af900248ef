"""The packed-plane kernels for Hopper: build, bind and launch.

``csrc/packbits.cu`` holds two kernels of the sim engines' word substrate
(``sim/packbits.py``), neither of which torch can express in one call:

* S1 ``row_reduce`` — bitwise OR or AND over the node axis of an
  int32[N, W] plane, optionally over the rows of a bool[N] mask only;
  replaces the XLA halving tree of ``ringpop_tpu/sim/packbits.py``
  (``_tree_reduce_rows``);
* S2 ``popcount_rows`` — per-row set-bit count, int32[N]; replaces
  ``lax.population_count`` + sum.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``ops/_cuda_build.py``) and loaded with ctypes; nothing is built or loaded
when this module is imported.  The launchers take CUDA tensors only and
raise on anything else: the plain versions live in ``sim/packbits.py``,
which dispatches by device.  ``launches`` counts each kernel's launches
(one per launcher call that reaches the card), so a run can show its main
path went through the kernels; :func:`reset_launches` sets them to 0.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from ringpop_tpu_torch.ops import _cuda_build

SOURCE = _cuda_build.CSRC / "packbits.cu"
BUILD_DIR: Optional[Path] = None  # None: _cuda_build.build_dir(), the configured build cache

_OPS = {"or": (0, 0), "and": (1, -1)}  # op -> (kernel op id, identity word)

launches = {"row_reduce": 0, "popcount_rows": 0}

_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """Compile ``csrc/packbits.cu`` unless the library for this source is
    already built.  Raises RuntimeError on failure."""
    return _cuda_build.build(SOURCE, BUILD_DIR)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.rp_row_reduce.argtypes = [ptr, ptr, i64, i32, i32, i32, ptr, ptr]
            lib.rp_popcount_rows.argtypes = [ptr, i64, i32, i32, ptr, ptr]
            lib.rp_row_reduce.restype = i32
            lib.rp_popcount_rows.restype = i32
            _lib = lib
        return _lib


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in launches:
        launches[name] = 0


def vec_words(width: int, address: int) -> int:
    """Words per load: the widest of 4, 2, 1 that divides the row width
    and whose byte size divides the base address (so every row's loads
    are aligned)."""
    for vec in (4, 2, 1):
        if width % vec == 0 and address % (4 * vec) == 0:
            return vec
    raise ValueError(f"plane base {address:#x} is not 4-byte aligned")


def _check_plane(p: torch.Tensor, what: str) -> None:
    if not p.is_cuda:
        raise ValueError(f"{what} needs a CUDA tensor, got {p.device}")
    if p.dtype != torch.int32 or p.dim() != 2:
        raise ValueError(f"{what} takes an int32[N, W] plane, got {p.dtype}{list(p.shape)}")
    if not p.is_contiguous():
        raise ValueError(f"{what}: the plane must be contiguous")


def reduce_rows_cuda(p: torch.Tensor, op: str, rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch S1: int32[N, W] CUDA plane -> int32[W], the bitwise ``op``
    ("or" or "and") over its rows — only over the rows where ``rows``
    (bool[N], same device) is True when it is given.  Raises ValueError for
    tensors it does not take and RuntimeError when the kernel cannot be
    built or its launch is refused."""
    if op not in _OPS:
        raise ValueError(f"unknown row reduce {op!r}")
    _check_plane(p, "reduce_rows_cuda")
    n, w = p.shape
    if rows is not None:
        if rows.dtype != torch.bool or rows.shape != (n,) or rows.device != p.device:
            raise ValueError(f"rows must be bool[{n}] on {p.device}, got {rows.dtype}{list(rows.shape)} on {rows.device}")
        rows = rows.contiguous()
    op_id, identity = _OPS[op]
    out = torch.full((w,), identity, dtype=torch.int32, device=p.device)
    if n and w:
        lib = _library()
        vec = vec_words(w, p.data_ptr())
        with torch.cuda.device(p.device):
            err = lib.rp_row_reduce(
                p.data_ptr(), None if rows is None else rows.data_ptr(), n, w, op_id, vec,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"row_reduce kernel ({op}) launch failed: cudaError {err}")
        launches["row_reduce"] += 1
    return out


def popcount_rows_cuda(p: torch.Tensor) -> torch.Tensor:
    """Launch S2: int32[N, W] CUDA plane -> int32[N] set-bit counts.
    Raises as :func:`reduce_rows_cuda` does."""
    _check_plane(p, "popcount_rows_cuda")
    n, w = p.shape
    if not w:
        return torch.zeros(n, dtype=torch.int32, device=p.device)
    out = torch.empty(n, dtype=torch.int32, device=p.device)
    if n:
        lib = _library()
        vec = vec_words(w, p.data_ptr())
        with torch.cuda.device(p.device):
            err = lib.rp_popcount_rows(
                p.data_ptr(), n, w, vec, out.data_ptr(), torch.cuda.current_stream().cuda_stream
            )
        if err != 0:
            raise RuntimeError(f"popcount_rows kernel launch failed: cudaError {err}")
        launches["popcount_rows"] += 1
    return out
