"""Kernel T1 for Hopper — the jax.random threefry draws: build, bind, launch.

``csrc/threefry.cu`` computes the draws of ``sim/threefry.py`` in one
launch each, on the card, from a key that stays there:

* ``split`` — int64[num, 2], the fold-like ``jax.random.split``;
* ``bits`` — int64 holding uint32, ``bits1 ^ bits2`` of threefry2x32;
* ``randint`` — int32, ``jax.random.randint``: the key split once a
  block, and one bit stream where the span arithmetic makes the other dead
  (``span_multiplier`` is 0), else both and the wrapping uint32 span
  arithmetic, with every remainder by the span a multiply by its
  :func:`reciprocal`;
* ``uniform`` — float32, ``jax.random.uniform``;
* ``fold_in`` — int64[2], ``jax.random.fold_in``: one thread, one cipher.

The same source holds kernel C1, ``categorical``: int32[R] or int32[R, r],
``jax.random.categorical`` over the logits 0 / -inf of a bool mask
(``sim/threefry.py:categorical_masked``): the draw and the first argmax of
a (row, rep) in one warp, in runs of eight elements a lane, so the ``[R,
N]`` or ``[R, r, N]`` draw is never written.  It replaces XLA's Gumbel draw
and argmax at ``ringpop_tpu/sim/fullview.py:296,375``.

T1 replaces XLA's lowering of threefry2x32 (``jax/_src/prng.py``,
``_threefry2x32_lowering``) at the engines' draw sites; no Pallas kernel.
The plain versions live in ``sim/threefry.py``, which dispatches by the
key's device.  The launchers take CUDA tensors only and raise on anything
else.  The source is compiled with ``nvcc`` for ``sm_90a`` at first use
(``ops/_cuda_build.py``) and loaded with ctypes; nothing is built or loaded
when this module is imported.  ``launches`` counts each kernel's launches
(one per launcher call that reaches the card); :func:`reset_launches` sets
them to 0.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from ringpop_tpu_torch.ops import _cuda_build

SOURCE = _cuda_build.CSRC / "threefry.cu"
BUILD_DIR: Optional[Path] = None  # None: _cuda_build.build_dir(), the configured build cache
INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1
# C1 indexes a row's columns and runs in int32
CATEGORICAL_MAX_COLS = 2**30

launches = {"split": 0, "bits": 0, "randint": 0, "uniform": 0, "fold_in": 0, "categorical": 0}

_lib = None
_lib_lock = threading.Lock()


def build(defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/threefry.cu`` unless the library for this source is
    already built; ``defines`` (``RP_THREEFRY_THREADS=...``,
    ``RP_THREEFRY_PER_THREAD=...``) make a measurement build of another
    block size or run length.  Raises RuntimeError on failure."""
    return _cuda_build.build(SOURCE, BUILD_DIR, defines)


def load(path: Path) -> ctypes.CDLL:
    """The built library at ``path`` with its entry points' signatures."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, u32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong, ctypes.c_float
    lib.rp_threefry_split.argtypes = [ptr, i64, ptr, ptr]
    lib.rp_threefry_bits.argtypes = [ptr, i64, ptr, ptr]
    lib.rp_threefry_randint.argtypes = [ptr, i64, i32, u32, u32, i32, u32, i32, i32, i32, ptr, ptr]
    lib.rp_threefry_uniform.argtypes = [ptr, i64, f32, f32, ptr, ptr]
    lib.rp_threefry_fold_in.argtypes = [ptr, u32, ptr, ptr]
    lib.rp_threefry_categorical_rows.argtypes = [ptr, ptr, i64, i64, i32, ptr, ptr]
    for fn in (lib.rp_threefry_split, lib.rp_threefry_bits, lib.rp_threefry_randint, lib.rp_threefry_uniform,
               lib.rp_threefry_fold_in, lib.rp_threefry_categorical_rows):
        fn.restype = i32
    return lib


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = load(build())
        return _lib


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for name in launches:
        launches[name] = 0


def span_multiplier(lo: int, hi: int) -> tuple[int, int]:
    """randint's (span, multiplier) for int32 bounds: the span is
    ``hi - lo`` as uint32, or 1 when ``hi <= lo``; the multiplier is JAX's
    ``((2**16 mod span)**2) mod span`` with the square in wrapping uint32,
    so it is 0 for every span above 2**16 (where 2**16 mod span is 2**16)."""
    if not (INT32_MIN <= lo <= INT32_MAX and INT32_MIN <= hi <= INT32_MAX):
        raise ValueError(f"randint bounds [{lo}, {hi}) must be int32 values")
    span = (hi - lo) & 0xFFFF_FFFF if hi > lo else 1
    return span, (((2**16 % span) ** 2) & 0xFFFF_FFFF) % span


def reciprocal(d: int) -> tuple[int, bool, int, int]:
    """``(magic, add, shift1, shift2)`` such that, in uint32 arithmetic,
    ``t = (magic * a) >> 32``, ``q = t + ((a - t) >> shift1)`` when
    ``add`` else ``t``, then ``q >> shift2`` is ``a // d`` for every uint32
    ``a``: Granlund and Montgomery's round-up multiplier, as libdivide
    builds it, for a divisor ``1 <= d < 2**32``.  ``add`` marks a magic
    number of 33 bits, whose top bit (``a`` itself) is added back halved;
    ``d = 1`` takes the same route with no halving.  A power of two ``2**l``
    is the multiply by ``2**(32 - l)``."""
    if not 1 <= d < 2**32:
        raise ValueError(f"divisor {d} is not a uint32 value above 0")
    if d == 1:
        return 1, True, 0, 0
    log2 = d.bit_length() - 1
    if d & (d - 1) == 0:
        return 1 << (32 - log2), False, 0, 0
    magic, rem = divmod(1 << (32 + log2), d)
    if d - rem < 1 << log2:  # the 32-bit magic number is exact at every dividend
        return magic + 1, False, 0, log2
    return (1 << (33 + log2)) // d - (1 << 32) + 1, True, 1, log2


def randint_variant(lo: int, hi: int) -> tuple[int, int, bool, tuple[int, bool, int, int]]:
    """The launch parameters of randint for int32 bounds: ``(span,
    multiplier, two_streams, reciprocal(span))``.  One stream (``lower``)
    when the multiplier is 0, since ``higher`` then does not reach the
    output."""
    span, mult = span_multiplier(lo, hi)
    return span, mult, mult != 0, reciprocal(span)


def _check_key(key: torch.Tensor, what: str) -> None:
    if not key.is_cuda:
        raise ValueError(f"{what} needs a CUDA key, got {key.device}")
    if key.dtype != torch.int64 or key.shape != (2,):
        raise ValueError(f"{what} takes a raw key int64[2], got {key.dtype}{list(key.shape)}")


def _call(name: str, entry: str, key: torch.Tensor, *args) -> None:
    """Call the library's entry point ``entry`` with the key, ``args`` and
    the current stream of the key's device; raise if the launch failed,
    else count it under ``name``."""
    lib = _library()
    key = key.contiguous()
    with torch.cuda.device(key.device):
        err = getattr(lib, entry)(key.data_ptr(), *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry {name} kernel launch failed: cudaError {err}")
    launches[name] += 1


def _launch(name: str, key: torch.Tensor, out: torch.Tensor, *args) -> torch.Tensor:
    """Launch kernel ``name`` over ``out``'s elements (none for an empty
    draw) on the current stream of the key's device."""
    count = out.numel() // 2 if name == "split" else out.numel()
    if count:
        _call(name, f"rp_threefry_{name}", key, count, *args, out.data_ptr())
    return out


def split_cuda(key: torch.Tensor, num: int) -> torch.Tensor:
    """Launch T1 (split): int64[num, 2] keys on the key's device."""
    _check_key(key, "split_cuda")
    out = torch.empty((num, 2), dtype=torch.int64, device=key.device)
    return _launch("split", key, out)


def bits_cuda(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Launch T1 (bits): int64[*shape] holding uint32."""
    _check_key(key, "bits_cuda")
    return _launch("bits", key, torch.empty(shape, dtype=torch.int64, device=key.device))


def randint_cuda(key: torch.Tensor, shape: tuple[int, ...], lo: int, hi: int) -> torch.Tensor:
    """Launch T1 (randint): int32[*shape] in [lo, hi), int32 bounds."""
    _check_key(key, "randint_cuda")
    span, mult, two_streams, (magic, add, shift1, shift2) = randint_variant(lo, hi)
    out = torch.empty(shape, dtype=torch.int32, device=key.device)
    return _launch("randint", key, out, lo, span, mult, two_streams, magic, add, shift1, shift2)


def uniform_cuda(key: torch.Tensor, shape: tuple[int, ...], minval: float = 0.0,
                 maxval: float = 1.0) -> torch.Tensor:
    """Launch T1 (uniform): float32[*shape] in [minval, maxval); the bounds
    are rounded to float32 first, as the JAX call converts them."""
    _check_key(key, "uniform_cuda")
    out = torch.empty(shape, dtype=torch.float32, device=key.device)
    return _launch("uniform", key, out, ctypes.c_float(minval), ctypes.c_float(maxval))


def fold_in_cuda(key: torch.Tensor, data: int) -> torch.Tensor:
    """Launch T1 (fold_in): the key int64[2] ``threefry2x32(key, (0, data))``
    for ``0 <= data < 2**32``."""
    _check_key(key, "fold_in_cuda")
    if not 0 <= data < 2**32:
        raise ValueError(f"fold_in takes data in [0, 2**32), got {data}")
    out = torch.empty(2, dtype=torch.int64, device=key.device)
    _call("fold_in", "rp_threefry_fold_in", key, data, out.data_ptr())
    return out


def categorical_cuda(key: torch.Tensor, mask: torch.Tensor, reps=None) -> torch.Tensor:
    """Launch C1 (categorical): int32[R] (``reps`` None) or int32[R, reps],
    the masked categorical draw of each row of the bool ``mask[R, N]``."""
    _check_key(key, "categorical_cuda")
    if mask.dtype != torch.bool or mask.dim() != 2:
        raise ValueError(f"categorical_cuda takes a bool mask [R, N], got {mask.dtype}{list(mask.shape)}")
    if mask.device != key.device:
        raise ValueError(f"the mask ({mask.device}) and the key ({key.device}) are on different devices")
    n_rows, n = mask.shape
    r = 1 if reps is None else int(reps)
    if r < 1 or r * n_rows >= 2**31:
        raise ValueError(f"categorical_cuda draws up to 2**31 - 1 rows x reps, got {n_rows} x {r}")
    if n > CATEGORICAL_MAX_COLS:
        raise ValueError(f"categorical_cuda draws rows of at most 2**30 columns, got {n}")
    out = torch.empty((n_rows, r), dtype=torch.int32, device=key.device)
    if out.numel() and not n:
        raise ValueError("categorical_cuda needs at least one column to draw from")
    if out.numel():
        mask = mask.contiguous()
        _call("categorical", "rp_threefry_categorical_rows", key, mask.data_ptr(), n_rows, n, r, out.data_ptr())
    return out[:, 0] if reps is None else out
