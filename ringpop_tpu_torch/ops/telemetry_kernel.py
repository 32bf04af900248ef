"""The telemetry-plane kernels for Hopper: build, bind and launch.

``csrc/telemetry.cu`` holds three kernels of the sim plane's telemetry
(``sim/telemetry.py``), none of which torch can express in one call:

* D1 ``state_digest`` — the position-sensitive digest of a state: per leaf
  the wrapping uint32 sum of ``mix32(value ^ mix32(flat index))``, then
  the leaves' sums mixed and summed, in one launch over a table of the
  leaves; replaces XLA's fused passes of ``ringpop_tpu/sim/telemetry.py``
  ``leaf_digest_sum`` / ``tree_digest``;
* P1 ``accumulate`` — one tick of the telemetry accumulators' [N, W] and
  [N] legs, in place: three popcounts of packed planes and five counters;
  replaces XLA's elementwise passes of ``telemetry.accumulate``;
* R1 ``f32_sums`` — a record's float32 sums in XLA:CPU's order, bit for
  bit the JAX package's ``sum(dtype=float32)``, in two launches for the
  whole record (``sim/telemetry.py`` plans each input's first level);
  replaces XLA's reduce-windows of ``telemetry.fetch``.

The source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``ops/_cuda_build.py``) and loaded with ctypes; nothing is built or loaded
when this module is imported.  The launchers take CUDA tensors only and
raise on anything else: the plain versions live in ``sim/telemetry.py``,
which dispatches by device.  ``launches`` counts each kernel's launches;
:func:`reset_launches` sets them to 0.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence

import torch

from ringpop_tpu_torch.ops import _cuda_build

SOURCE = _cuda_build.CSRC / "telemetry.cu"
BUILD_DIR: Optional[Path] = None  # None: _cuda_build.build_dir(), the configured build cache
MAX_LEAVES = 64  # csrc/telemetry.cu kMaxLeaves: the leaves one digest launch takes
MAX_SUMS = 32  # csrc/telemetry.cu kMaxSums: the inputs one R1 call takes (a column of a plane counts one)
SUM_WINDOW = 32  # csrc/telemetry.cu kSumWindow

# leaf dtype -> the kernel's element kind (bool 0/1, int8 sign-extended,
# int32 as its bits, int64 by its low word)
KINDS = {torch.bool: 0, torch.uint8: 0, torch.int8: 1, torch.int32: 2, torch.int64: 3}

launches = {"state_digest": 0, "accumulate": 0, "f32_sums": 0}  # R1 counts each of its two launches

_lib = None
_lib_lock = threading.Lock()


def build(defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/telemetry.cu`` (with the macros ``defines``, for a
    build whose SASS is counted) unless that library is already built.
    Raises RuntimeError on failure."""
    return _cuda_build.build(SOURCE, BUILD_DIR, defines)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.rp_state_digest.argtypes = [ptr, ptr, ptr, ptr, i32, i32, ptr, ptr, ptr]
            lib.rp_telemetry_accumulate.argtypes = [ptr] * 6 + [i64, i32] + [ptr] * 8 + [i32] + [ptr] * 4
            lib.rp_f32_sums.argtypes = [ptr] * 6 + [i32, ptr, ptr, i64, ptr, ptr, ptr]
            lib.rp_state_digest.restype = i32
            lib.rp_telemetry_accumulate.restype = i32
            lib.rp_f32_sums.restype = i32
            _lib = lib
        return _lib


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in launches:
        launches[name] = 0


def state_digest_cuda(leaves: Sequence[torch.Tensor], offset: int = 0, final: bool = True) -> torch.Tensor:
    """Launch D1 over ``leaves`` (CUDA tensors of one device, of the
    dtypes of :data:`KINDS`, at most :data:`MAX_LEAVES`): with ``final``,
    the tree digest (each leaf's sum from flat index 0, mixed with its
    position); else the one leaf's sum from flat index ``offset``.  Returns
    a 0-d int64 tensor holding the uint32.  Raises ValueError for tensors
    it does not take and RuntimeError when the kernel cannot be built or
    its launch is refused."""
    leaves = list(leaves)
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"state_digest_cuda takes 1 to {MAX_LEAVES} leaves, got {len(leaves)}")
    if not final and len(leaves) != 1:
        raise ValueError("a leaf sum (final=False) takes one leaf")
    dev = leaves[0].device
    for leaf in leaves:
        if not leaf.is_cuda or leaf.device != dev:
            raise ValueError(f"state_digest_cuda needs CUDA tensors on one device, got {leaf.device}")
        if leaf.dtype not in KINDS:
            raise ValueError(f"state_digest_cuda takes {sorted(map(str, KINDS))} leaves, got {leaf.dtype}")
    leaves = [leaf.contiguous() for leaf in leaves]
    count = len(leaves)
    ptrs = (ctypes.c_void_p * count)(*(leaf.data_ptr() for leaf in leaves))
    ns = (ctypes.c_longlong * count)(*(leaf.numel() for leaf in leaves))
    offsets = (ctypes.c_uint * count)(*([offset & 0xFFFF_FFFF] + [0] * (count - 1)))
    kinds = (ctypes.c_int * count)(*(KINDS[leaf.dtype] for leaf in leaves))
    slots = torch.zeros(count + 1, dtype=torch.int32, device=dev)
    out = torch.empty((), dtype=torch.int64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rp_state_digest(ptrs, ns, offsets, kinds, count, int(final), slots.data_ptr(), out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"state_digest kernel launch failed: cudaError {err}")
    launches["state_digest"] += 1
    return out


def _plane(x: torch.Tensor, shape, what: str) -> torch.Tensor:
    if x.dtype != torch.int32 or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} must be int32{list(shape)}, got {x.dtype}{list(x.shape)}")
    return x


def _mask(x: torch.Tensor, shape, what: str) -> torch.Tensor:
    if x.dtype != torch.bool or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} must be bool{list(shape)}, got {x.dtype}{list(x.shape)}")
    return x.contiguous()


def accumulate_cuda(acc: dict, *, sent_w, resp_w, ride_ok, mid_ride_w, delivered, probing, peer_ok, refute,
                    placed, base_fired) -> None:
    """Launch P1: add one tick to the accumulators ``acc`` (``piggybacked``
    and ``expired`` int32[N, W]; ``pings``, ``ping_reqs``, ``probes_failed``,
    ``incarnation_bumps``, ``base_timer_fires`` int32[N]: contiguous CUDA
    tensors, updated in place) from the tick's planes (int32[N, W]) and
    masks (bool[N]; ``peer_ok`` bool[N, P]).  Raises as
    :func:`state_digest_cuda` does."""
    pig, exp = acc["piggybacked"], acc["expired"]
    if not pig.is_cuda:
        raise ValueError(f"accumulate_cuda needs CUDA tensors, got {pig.device}")
    n, w = pig.shape
    planes = [_plane(x, (n, w), name) for name, x in (
        ("piggybacked", pig), ("expired", exp), ("sent_w", sent_w), ("resp_w", resp_w), ("ride_ok", ride_ok),
        ("mid_ride_w", mid_ride_w))]
    counters = [_plane(acc[name], (n,), name) for name in (
        "pings", "ping_reqs", "probes_failed", "incarnation_bumps", "base_timer_fires")]
    for x in planes[:2] + counters:
        if not x.is_contiguous():
            raise ValueError("the accumulators must be contiguous: P1 updates them in place")
    planes[2:] = [x.contiguous() for x in planes[2:]]
    masks = [_mask(x, (n,), name) for name, x in (("delivered", delivered), ("probing", probing))]
    p = peer_ok.shape[1] if peer_ok.dim() == 2 else -1
    peer = _mask(peer_ok, (n, p), "peer_ok")
    tail = [_mask(x, (n,), name) for name, x in (("refute", refute), ("placed", placed),
                                                 ("base_fired", base_fired))]
    for x in planes + counters + masks + [peer] + tail:
        if x.device != pig.device:
            raise ValueError(f"accumulate_cuda needs every tensor on {pig.device}, got {x.device}")
    if w == 0:
        raise ValueError("accumulate_cuda needs planes of at least one word")
    if n == 0:
        return
    lib = _library()
    with torch.cuda.device(pig.device):
        err = lib.rp_telemetry_accumulate(
            *(x.data_ptr() for x in planes), n, w, *(x.data_ptr() for x in counters),
            *(x.data_ptr() for x in masks), peer.data_ptr(), p, *(x.data_ptr() for x in tail),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"accumulate kernel launch failed: cudaError {err}")
    launches["accumulate"] += 1


# input dtype -> R1's element kind (0 bool, 1 int32, 2 uint32 held in int32)
SUM_KINDS = {torch.bool: 0, torch.int32: 1}


def f32_sums_cuda(inputs: Sequence[tuple]) -> torch.Tensor:
    """Launch R1 over ``inputs``, a list of ``(x, unsigned, by_column,
    lanes)``: CUDA tensors of one device, bool or int32 (``unsigned``: int32
    holding uint32 bits) of at most two dimensions; ``by_column`` sums an
    [N, C] tensor by column (C outputs); ``lanes`` is the first level's plan
    (``sim.telemetry.sum_lanes``: 0 exact, 1 in order, 4 or 8 lanes; 1 for
    a sum by column).  Returns float32 [outputs], the sums in order.  Two
    launches (one when every input is empty).  Raises as
    :func:`state_digest_cuda` does."""
    cols = []  # (tensor, element offset, rows, width, ld, kind, lanes)
    dev = inputs[0][0].device if inputs else None
    for x, unsigned, by_column, lanes in inputs:
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"f32_sums_cuda needs CUDA tensors on one device, got {x.device}")
        if x.dtype not in SUM_KINDS or (unsigned and x.dtype != torch.int32) or x.dim() > 2:
            raise ValueError(f"f32_sums_cuda takes bool or int32 tensors of at most two dimensions, got "
                             f"{x.dtype}{list(x.shape)}")
        x = x.contiguous()
        kind = 2 if unsigned else SUM_KINDS[x.dtype]
        if by_column:
            if x.dim() != 2:
                raise ValueError(f"a sum by column takes an [N, C] tensor, got {list(x.shape)}")
            cols += [(x, c, x.shape[0], 1, x.shape[1], kind, 1) for c in range(x.shape[1])]
        else:
            rows = x.shape[0] if x.dim() else 1
            width = x.shape[1] if x.dim() == 2 else 1
            cols.append((x, 0, rows, width, width, kind, lanes))
    count = len(cols)
    if not 1 <= count <= MAX_SUMS:
        raise ValueError(f"f32_sums_cuda takes 1 to {MAX_SUMS} sums, got {count}")
    if any(width < 1 for _, _, _, width, _, _, _ in cols):
        raise ValueError("f32_sums_cuda takes rows of at least one word")
    windows = sum(-(-rows // SUM_WINDOW) for _, _, rows, _, _, _, _ in cols)
    ptrs = (ctypes.c_void_p * count)(*(x.data_ptr() + off * x.element_size() for x, off, *_ in cols))
    rows = (ctypes.c_longlong * count)(*(c[2] for c in cols))
    widths, lds, kinds, lanes = ((ctypes.c_int * count)(*(c[i] for c in cols)) for i in (3, 4, 5, 6))
    fwin = torch.empty(2 * max(windows, 1), dtype=torch.float32, device=dev)
    xwin = torch.empty(2 * max(windows, 1) if any(c[6] == 0 for c in cols) else 1, dtype=torch.int64, device=dev)
    out = torch.empty(count, dtype=torch.float32, device=dev)
    launched = ctypes.c_int(0)
    lib = _library()
    with torch.cuda.device(dev):
        err = lib.rp_f32_sums(ptrs, rows, widths, lds, kinds, lanes, count, fwin.data_ptr(), xwin.data_ptr(), windows,
                              out.data_ptr(), ctypes.byref(launched), torch.cuda.current_stream().cuda_stream)
    launches["f32_sums"] += launched.value
    if err != 0:
        raise RuntimeError(f"f32_sums kernel launch failed: cudaError {err}")
    return out
