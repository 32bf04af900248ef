"""The lifecycle engine's kernels for Hopper: plain versions, build, launch.

``csrc/lifecycle.cu`` holds two kernels of ``sim/lifecycle.py`` that torch
cannot express in one call:

* L1 ``slot_walk`` — the per-subject slot walk under
  ``detection_complete`` and ``view_checksums``: per node, the K rumor slots
  sorted by (subject asc, key desc), each subject's governing key combined
  into a view checksum (checksum mode) or into a per-subject "some observer
  has not detected it" flag (detect mode); replaces the XLA ``fori_loop``
  of ``ringpop_tpu/sim/lifecycle.py`` (``_walk_subject_slots``);
* L2 ``first_live_learner`` — per wanted slot, the lowest live row that
  learned it (0 where none did, and for the slots not wanted); replaces
  ``_first_live_learner``'s argmax over the unpacked [N, K] plane and the
  ``lax.cond`` around it, on the card, with no host sync.

Each has its plain PyTorch version here (:func:`slot_walk_plain`,
:func:`first_live_learner_plain`); :func:`slot_walk` and
:func:`first_live_learner` dispatch by device: the plain version for a CPU
tensor, the kernel for a CUDA tensor (or an error — never a fallback).
Both kernels keep per-word tables in shared memory, so on the card they
take planes of at most :data:`MAX_WORDS` words (K <= 7008 slots).  The
source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``ops/_cuda_build.py``) and loaded with ctypes; nothing is built or loaded
when this module is imported.  ``launches`` counts each kernel's launches;
:func:`reset_launches` sets them to 0.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from ringpop_tpu_torch.ops import _cuda_build
from ringpop_tpu_torch.ops.packbits_kernel import vec_words
from ringpop_tpu_torch.sim.packbits import M32, bit_column, mix32, unpack_bits
from ringpop_tpu_torch.swim.member import TOMBSTONE, key_state

SOURCE = _cuda_build.CSRC / "lifecycle.cu"
BUILD_DIR: Optional[Path] = None  # None: _cuda_build.build_dir(), the configured build cache

MODES = {"checksum": 0, "detect": 1}
INT32_MAX = 2**31 - 1
# The widest plane both kernels take: L2's per-warp first-row tables (1060
# bytes a word, rp_first_live_learner_smem) fill one Hopper block's 227 KB
# at 219 words; L1's tables fit there at K = 32W too (rp_slot_walk_smem).
MAX_WORDS = 219

launches = {"slot_walk": 0, "first_live_learner": 0}

_lib = None
_lib_lock = threading.Lock()
_learner_scratch: dict = {}


def build() -> Path:
    """Compile ``csrc/lifecycle.cu`` unless the library for this source is
    already built.  Raises RuntimeError on failure."""
    return _cuda_build.build(SOURCE, BUILD_DIR)


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.rp_slot_walk.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr,
                                         ptr, ptr]
            lib.rp_slot_walk.restype = i32
            lib.rp_slot_walk_smem.argtypes = [i32, i32, i32]
            lib.rp_slot_walk_smem.restype = i64
            lib.rp_first_live_learner.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr, ptr, ptr]
            lib.rp_first_live_learner.restype = i32
            lib.rp_first_live_learner_smem.argtypes = [i32]
            lib.rp_first_live_learner_smem.restype = i64
            lib.rp_first_live_learner_scratch.argtypes = [i32]
            lib.rp_first_live_learner_scratch.restype = i64
            lib.rp_first_live_learner_best_at.restype = i64
            _lib = lib
        return _lib


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in launches:
        launches[name] = 0


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if not t.is_cuda:
        raise ValueError(f"{what} needs CUDA tensors, got {t.device}")


def check_width(w: int, what: str) -> None:
    """Raise ValueError for a plane of ``w`` words wider than the kernels
    take (:data:`MAX_WORDS`)."""
    if w > MAX_WORDS:
        raise ValueError(f"{what}: a plane of {w} words is wider than the lifecycle kernels take "
                         f"({MAX_WORDS} words, K <= {32 * MAX_WORDS}: their tables fill a block's shared memory)")


# -- L1: the subject-slot walk -------------------------------------------------


def walk_order(r_subject: torch.Tensor, rkey: torch.Tensor, n: int):
    """The walk's slot order: the K slots sorted by (subject asc, key desc),
    free slots (subject -1) pushed past the end as subject ``n``, ties in
    slot order — ``jnp.lexsort((-rkey, subj_or_sentinel))``, as one stable
    sort of the int64 key ``subj * 2**32 + (2**31 - rkey)`` (rkey >= -1, so
    the low part stays in [1, 2**32)).  Returns (order int64[K],
    sorted_subj int32[K], sorted_key int32[K])."""
    subj = torch.where(r_subject >= 0, r_subject, n).to(torch.int64)
    composite = subj * (1 << 32) + ((1 << 31) - rkey.to(torch.int64))
    order = torch.sort(composite, stable=True).indices
    return order, subj[order].to(torch.int32), rkey[order].to(torch.int32)


def member_term(subject, key: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32: the view checksum's contribution of (subject,
    governing key), ``mix32(mix32(subject) ^ key)``, zero when the key is
    absent (< 0) or a tombstone (the reference excludes tombstones)."""
    include = (key >= 0) & (key_state(key.clamp_min(0)) != TOMBSTONE)
    h = mix32(mix32(subject) ^ (key.to(torch.int64) & M32))
    return torch.where(include, h, 0)


def slot_walk_keys_plain(learned: torch.Tensor, order: torch.Tensor, sorted_subj: torch.Tensor,
                         sorted_key: torch.Tensor, base_key: torch.Tensor):
    """The pass of :func:`slot_walk_plain` that both modes share: the JAX
    package's walk, one step per sorted slot over the plane's columns,
    keeping each node's best learned key of the current subject.  Returns
    (keys int32[R, K]: column j the node's governing key of slot j's
    subject as of slot j, with the subject's base key; is_last bool[K]: the
    slots that close their subject's run, whose column covers the whole
    run).  :func:`slot_walk_finish_plain` reduces it in either mode, so one
    pass serves every mode and observer mask."""
    rows = learned.shape[0]
    n = base_key.shape[0]
    k = order.shape[0]
    dev = learned.device
    # the sorted positions that close their subject's run (free slots close nothing)
    nxt = torch.cat([sorted_subj[1:], sorted_subj.new_full((1,), n + 1)])
    is_last = (sorted_subj != nxt) & (sorted_subj < n)
    best = torch.full((rows,), -1, dtype=torch.int32, device=dev)
    keys = torch.empty((rows, k), dtype=torch.int32, device=dev)
    for j in range(k):
        s = sorted_subj[j]
        lcol = bit_column(learned, order[j])
        best = torch.where(lcol & (s < n), torch.maximum(best, sorted_key[j]), best)
        keys[:, j] = torch.maximum(best, base_key[s.clamp_max(n - 1)])
        best = torch.where(is_last[j], -1, best)
    return keys, is_last


def slot_walk_finish_plain(keys: torch.Tensor, is_last: torch.Tensor, sorted_subj: torch.Tensor, n: int,
                           mode: str, obs: Optional[torch.Tensor] = None, min_status: int = 0) -> torch.Tensor:
    """:func:`slot_walk_plain`'s result from :func:`slot_walk_keys_plain`'s
    pass: the closing slots' keys combined by mode."""
    subj = sorted_subj.clamp_max(n - 1)
    if mode == "checksum":
        return torch.where(is_last, member_term(subj, keys), 0).sum(dim=1) & M32
    bad = (obs[:, None] & (keys >= 0) & (key_state(keys.clamp_min(0)) < min_status)).any(dim=0)
    # each subject closes one run; the other slots write False past the end
    anybad = torch.zeros(n + 1, dtype=torch.bool, device=keys.device)
    anybad[torch.where(is_last, subj, n)] = bad & is_last
    return anybad[:n]


def slot_walk_plain(learned: torch.Tensor, order: torch.Tensor, sorted_subj: torch.Tensor,
                    sorted_key: torch.Tensor, base_key: torch.Tensor, mode: str,
                    obs: Optional[torch.Tensor] = None, min_status: int = 0) -> torch.Tensor:
    """The plain version of :func:`slot_walk`: the JAX package's walk
    (:func:`slot_walk_keys_plain`), each subject's governing keys combined
    at the subject's last slot (:func:`slot_walk_finish_plain`)."""
    keys, is_last = slot_walk_keys_plain(learned, order, sorted_subj, sorted_key, base_key)
    return slot_walk_finish_plain(keys, is_last, sorted_subj, base_key.shape[0], mode, obs, min_status)


def slot_walk_cuda(learned: torch.Tensor, order: torch.Tensor, sorted_subj: torch.Tensor,
                   sorted_key: torch.Tensor, base_key: torch.Tensor, mode: str,
                   obs: Optional[torch.Tensor] = None, min_status: int = 0) -> torch.Tensor:
    """Launch L1 on CUDA tensors; same contract as :func:`slot_walk_plain`.
    Raises ValueError for tensors it does not take and RuntimeError when the
    kernel cannot be built or its launch is refused."""
    if mode not in MODES:
        raise ValueError(f"unknown walk mode {mode!r}")
    _require_cuda(learned, "slot_walk_cuda")
    if learned.dtype != torch.int32 or learned.dim() != 2:
        raise ValueError(f"slot_walk_cuda takes an int32[R, W] plane, got {learned.dtype}{list(learned.shape)}")
    rows, w = learned.shape
    n = base_key.shape[0] if base_key.dim() == 1 else -1
    k = order.shape[0]
    dev = learned.device
    if not 1 <= k < (1 << 24) or 32 * w < k or n >= 2**31 or not rows <= n:
        raise ValueError(f"slot_walk_cuda: unsupported shape R={rows} N={n} W={w} K={k}")
    if sorted_subj.shape != (k,) or sorted_key.shape != (k,):
        raise ValueError("slot_walk_cuda: the slot vectors must be [K]")
    if mode == "detect" and (obs is None or obs.dtype != torch.bool or obs.shape != (rows,)):
        raise ValueError(f"slot_walk_cuda: detect mode needs a bool[{rows}] observer mask")
    tensors = [learned, order, sorted_subj, sorted_key, base_key] + ([obs] if mode == "detect" else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("slot_walk_cuda: every tensor must be on the plane's device")
    check_width(w, "slot_walk_cuda")
    learned = learned.contiguous()
    order32 = order.to(torch.int32).contiguous()
    sorted_subj = sorted_subj.to(torch.int32).contiguous()
    sorted_key = sorted_key.to(torch.int32).contiguous()
    base_key = base_key.to(torch.int32).contiguous()
    sums = torch.empty(rows if mode == "checksum" else 0, dtype=torch.int64, device=dev)
    anybad = torch.zeros(n if mode == "detect" else 0, dtype=torch.bool, device=dev)
    obs_c = obs.contiguous() if mode == "detect" else None
    if rows:
        lib = _library()
        with torch.cuda.device(dev):
            err = lib.rp_slot_walk(
                learned.data_ptr(), rows, n, w, k, order32.data_ptr(), sorted_subj.data_ptr(),
                sorted_key.data_ptr(), base_key.data_ptr(),
                None if obs_c is None else obs_c.data_ptr(), int(min_status), MODES[mode],
                vec_words(w, learned.data_ptr()),
                sums.data_ptr() if mode == "checksum" else None,
                anybad.data_ptr() if mode == "detect" else None,
                torch.cuda.current_stream().cuda_stream,
            )
        if err != 0:
            raise RuntimeError(f"slot_walk kernel ({mode}) launch failed: cudaError {err}")
        launches["slot_walk"] += 1
    return sums if mode == "checksum" else anybad


def slot_walk(learned: torch.Tensor, order: torch.Tensor, sorted_subj: torch.Tensor,
              sorted_key: torch.Tensor, base_key: torch.Tensor, mode: str,
              obs: Optional[torch.Tensor] = None, min_status: int = 0) -> torch.Tensor:
    """The subject-slot walk over slots in :func:`walk_order`'s order, with
    ``base_key`` (int32[N], by subject id).  ``learned`` holds the nodes
    walked: all N rows, or a node rank's block of R rows (subjects stay
    global).  ``mode="checksum"``: int64[R] holding uint32, per node the
    wrapping sum over subjects that hold a slot of :func:`member_term` of
    the node's governing key.  ``mode="detect"``: bool[N] by subject id,
    True where some node with ``obs`` (bool[R]) set governs the subject by
    a present key of status below ``min_status`` (False for subjects
    without a slot).  The plain version on a CPU plane, L1 on a CUDA
    plane."""
    if learned.device.type == "cpu":
        return slot_walk_plain(learned, order, sorted_subj, sorted_key, base_key, mode, obs, min_status)
    return slot_walk_cuda(learned, order, sorted_subj, sorted_key, base_key, mode, obs, min_status)


# -- L2: the per-slot first live learner -----------------------------------------


def first_live_learner_plain(learned: torch.Tensor, up: Optional[torch.Tensor], k: int,
                             want: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of :func:`first_live_learner`: the lowest row
    index per slot column of the unpacked plane (not ``torch.argmax`` of
    a bool tensor, which the CPU build refuses), 0 where ``want`` is
    False."""
    n = learned.shape[0]
    bits = unpack_bits(learned, k)
    if up is not None:
        bits = bits & up[:, None]
    rows = torch.arange(n, dtype=torch.int32, device=learned.device)[:, None]
    first = torch.where(bits, rows, n).amin(0) if n else torch.zeros(k, dtype=torch.int32, device=learned.device)
    first = torch.where(first == n, 0, first).to(torch.int32)
    return first if want is None else torch.where(want, first, 0)


def _scratch_for(lib, dev: torch.device, stream: int, w: int) -> torch.Tensor:
    """L2's scratch on ``dev`` for launches on ``stream`` at W words (or
    fewer): int32, its two counters 0 and its best rows INT32_MAX
    (``rp_first_live_learner_best_at`` in ``csrc/lifecycle.cu``).  Each
    launch leaves it so; one is kept per device and stream, so launches
    that may overlap never share one."""
    key = (dev.index, stream)
    size = lib.rp_first_live_learner_scratch(w)
    buf = _learner_scratch.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(size, dtype=torch.int32, device=dev)
        buf[lib.rp_first_live_learner_best_at():] = INT32_MAX
        _learner_scratch[key] = buf
    return buf


def first_live_learner_cuda(learned: torch.Tensor, up: Optional[torch.Tensor], k: int,
                            want: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch L2 on a CUDA plane; same contract as
    :func:`first_live_learner_plain`.  Raises as :func:`slot_walk_cuda`."""
    _require_cuda(learned, "first_live_learner_cuda")
    if learned.dtype != torch.int32 or learned.dim() != 2 or not learned.is_contiguous():
        raise ValueError("first_live_learner_cuda takes a contiguous int32[N, W] plane")
    n, w = learned.shape
    dev = learned.device
    if n >= 2**31 or not 0 < k <= 32 * w:
        raise ValueError(f"first_live_learner_cuda: unsupported shape N={n} W={w} K={k}")
    check_width(w, "first_live_learner_cuda")
    for name, mask, size in (("up", up, n), ("want", want, k)):
        if mask is not None and (mask.dtype != torch.bool or mask.shape != (size,) or mask.device != dev):
            raise ValueError(f"{name} must be bool[{size}] on {dev}")
    up = None if up is None else up.contiguous()
    want = None if want is None else want.contiguous()
    if not n:
        return torch.zeros(k, dtype=torch.int32, device=dev)
    lib = _library()
    out = torch.empty(k, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        with _lib_lock:
            scratch = _scratch_for(lib, dev, stream, w)
        err = lib.rp_first_live_learner(
            learned.data_ptr(), None if up is None else up.data_ptr(),
            None if want is None else want.data_ptr(), n, w, k, vec_words(w, learned.data_ptr()),
            scratch.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"first_live_learner kernel launch failed: cudaError {err}")
    launches["first_live_learner"] += 1
    return out


def first_live_learner(learned: torch.Tensor, up: Optional[torch.Tensor], k: int,
                       want: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32[K]: per slot j < k that ``want`` (bool[K]; every slot when
    None) names, the lowest row r with bit j of ``learned[r]`` set and
    ``up[r]`` (every row when ``up`` is None); 0 where there is none, as
    ``jnp.argmax`` of an all-False column gives, and 0 for the slots not
    wanted.  The plain version on a CPU plane, L2 on a CUDA plane."""
    if learned.device.type == "cpu":
        return first_live_learner_plain(learned, up, k, want)
    return first_live_learner_cuda(learned, up, k, want)
