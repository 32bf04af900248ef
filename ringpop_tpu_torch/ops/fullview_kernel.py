"""Kernel F1 for Hopper — the full-view engine's change application.

``csrc/fullview.cu`` applies one batch of candidate changes to the seven
``[N, N]`` planes of a ``sim/fullview.FullViewState`` in one pass, in
place: the array form of ``memberlist.Update`` that
``ringpop_tpu/sim/fullview.py:_apply_batch`` (:171-241) runs as ~25 XLA
elementwise passes, five times a tick.  There is no Pallas kernel there.

:func:`apply_plain` is the plain PyTorch body of that function, line for
line; :func:`apply` dispatches by device: the plain version for CPU
tensors, the kernel for CUDA tensors (or an error — never a fallback).
Both update the planes in place.  A candidate is a key ``(incarnation <<
3) | state`` >= 0, or -1 for none, so incarnations must stay below 2**28
(the engine's ms clock reaches that after ~74 hours of simulated time).
The kernel reads and writes four cells at once as words, so it takes
int32 planes at 16-byte and byte planes at 4-byte aligned bases, and
finds a cell's row by a 32-bit quotient (:func:`reciprocal` of N), so it
takes N up to :data:`MAX_N`; :func:`apply_cuda` refuses anything else.
The source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``ops/_cuda_build.py``) and loaded with ctypes; nothing is built or loaded
when this module is imported.  ``launches`` counts the kernel's launches;
:func:`reset_launches` sets them to 0.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

from ringpop_tpu_torch.ops import _cuda_build
from ringpop_tpu_torch.ops.threefry_kernel import reciprocal
from ringpop_tpu_torch.swim.member import (
    ALIVE,
    FAULTY,
    KEY_STATE_BITS,
    LEAVE,
    SUSPECT,
    TOMBSTONE,
    is_detraction,
    pack_key,
)

SOURCE = _cuda_build.CSRC / "fullview.cu"
BUILD_DIR: Optional[Path] = None  # None: _cuda_build.build_dir(), the configured build cache

# the planes' dtypes, in FullViewState's field order
PLANE_DTYPES = (torch.int8, torch.int32, torch.bool, torch.bool, torch.int32, torch.int8, torch.int32)
# a cell's row is a 32-bit quotient: the kernel takes N * N < 2**32 cells
MAX_N = 65535

launches = {"apply": 0}

_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """Compile ``csrc/fullview.cu`` unless the library for this source is
    already built.  Raises RuntimeError on failure."""
    return _cuda_build.build(SOURCE, BUILD_DIR)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, u32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
            lib.rp_fullview_apply.argtypes = [ptr] * 10 + [i64, u32, i32, i32, i32, i32, i32, i32, ptr]
            lib.rp_fullview_apply.restype = i32
            _lib = lib
        return _lib


def reset_launches() -> None:
    """Set the kernel's launch count to 0."""
    for name in launches:
        launches[name] = 0


def apply_plain(planes: Sequence[torch.Tensor], cand_key: torch.Tensor, tick: torch.Tensor,
                now_ms: torch.Tensor, timeouts: tuple[int, int, int]) -> None:
    """The plain version of :func:`apply`: ``_apply_batch`` of the JAX
    package with ``cand_mask = cand_key >= 0``, its result copied into the
    planes."""
    status, inc, present, has_change, pcount, pending, deadline = planes
    n = status.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=status.device)
    cand_mask = cand_key >= 0
    cand_status = (cand_key & ((1 << KEY_STATE_BITS) - 1)).to(torch.int8)
    cand_inc = cand_key >> KEY_STATE_BITS

    local_key = pack_key(inc, status.to(torch.int32))
    local_eff = torch.where(present, local_key, -1)

    # refutation: a detraction about myself at inc >= mine
    refute = cand_mask & eye & is_detraction(cand_status) & (cand_inc >= inc) & present

    # non-local (and first-seen) override by strict key order
    wins = cand_mask & (cand_key > local_eff) & ~refute
    # first-seen tombstones are refused
    first_seen = wins & ~present
    wins &= ~(first_seen & (cand_status == TOMBSTONE))

    new_status = torch.where(wins, cand_status, status)
    new_inc = torch.where(wins, cand_inc, inc)
    new_present = present | wins

    # refutations reassert alive at a fresh wall-ms incarnation
    new_status = new_status.masked_fill(refute, ALIVE)
    new_inc = torch.where(refute, now_ms, new_inc)

    applied = wins | refute
    new_has_change = has_change | applied
    new_pcount = pcount.masked_fill(applied, 0)

    # alive/leave cancel; suspect/faulty/tombstone schedule unless a timer
    # for the same state is already pending; never for self
    cancel = applied & ((new_status == ALIVE) | (new_status == LEAVE))
    new_pending = pending.masked_fill(cancel, -1)
    new_deadline = deadline
    for st, ticks in zip((SUSPECT, FAULTY, TOMBSTONE), timeouts):
        sched = applied & (new_status == st) & ~eye & (pending != st)
        new_pending = new_pending.masked_fill(sched, st)
        new_deadline = torch.where(sched, tick + ticks, new_deadline)

    for plane, new in zip(planes, (new_status, new_inc, new_present, new_has_change, new_pcount, new_pending,
                                   new_deadline)):
        plane.copy_(new)


def _check(planes: Sequence[torch.Tensor], cand_key: torch.Tensor, tick: torch.Tensor, now_ms: torch.Tensor) -> int:
    if len(planes) != len(PLANE_DTYPES):
        raise ValueError(f"apply_cuda takes the {len(PLANE_DTYPES)} planes, got {len(planes)}")
    n = cand_key.shape[0]
    for t, dtype in zip((*planes, cand_key), (*PLANE_DTYPES, torch.int32)):
        if not t.is_cuda:
            raise ValueError(f"apply_cuda needs CUDA tensors, got {t.device}")
        if t.dtype != dtype or t.shape != (n, n) or not t.is_contiguous():
            raise ValueError(f"apply_cuda takes contiguous {dtype}[{n}, {n}] planes, got "
                             f"{t.dtype}{list(t.shape)}")
        if t.device != cand_key.device:
            raise ValueError("apply_cuda takes every tensor on one device")
        # four cells' bytes in one word, four int32 cells in one 16-byte load
        align = 4 * t.element_size()
        if t.data_ptr() % align:
            raise ValueError(f"apply_cuda reads {dtype} planes in {align}-byte words: their base must be "
                             f"{align}-byte aligned, got an address {t.data_ptr() % align} past it")
    if n > MAX_N:
        raise ValueError(f"apply_cuda takes N <= {MAX_N} (N * N < 2**32 cells: a cell's row is a 32-bit "
                         f"quotient), got {n}")
    for t in (tick, now_ms):
        if t.dtype != torch.int32 or t.numel() != 1 or t.device != cand_key.device:
            raise ValueError(f"apply_cuda takes tick and now_ms as int32 scalars on {cand_key.device}")
    return n


def apply_cuda(planes: Sequence[torch.Tensor], cand_key: torch.Tensor, tick: torch.Tensor,
               now_ms: torch.Tensor, timeouts: tuple[int, int, int]) -> None:
    """Launch F1: apply the candidates ``cand_key`` (int32[N, N], -1 none)
    to the planes in place, at the scalars ``tick`` and ``now_ms`` (int32,
    on the card) and the (suspect, faulty, tombstone) timeouts in ticks."""
    n = _check(planes, cand_key, tick, now_ms)
    if n == 0:
        return
    lib = _library()
    magic, add, shift1, shift2 = reciprocal(n)
    with torch.cuda.device(cand_key.device):
        err = lib.rp_fullview_apply(
            cand_key.data_ptr(), *(p.data_ptr() for p in planes), tick.data_ptr(), now_ms.data_ptr(), n,
            magic, add, shift1, shift2, *(int(t) for t in timeouts), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fullview apply kernel launch failed: cudaError {err}")
    launches["apply"] += 1


def apply(planes: Sequence[torch.Tensor], cand_key: torch.Tensor, tick: torch.Tensor, now_ms: torch.Tensor,
          timeouts: tuple[int, int, int]) -> None:
    """Apply a batch of candidate changes to the seven planes in place:
    the plain version on the CPU, F1 on the card."""
    if cand_key.device.type == "cpu":
        apply_plain(planes, cand_key, tick, now_ms, timeouts)
    else:
        apply_cuda(planes, cand_key, tick, now_ms, timeouts)
