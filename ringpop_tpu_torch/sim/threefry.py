"""The ``jax.random`` threefry stream (``rng="threefry"``), bit for bit.

Counterpart of the draws the JAX package's engines make through
``jax.random`` with the default threefry2x32 implementation, as jax 0.9
configures it (``jax_threefry_partitionable=True``):

* a key is int64[2] holding the uint32 pair ``[k1, k2]`` — the raw leaf of
  ``jax.random.PRNGKey(seed)``, ``[0, seed mod 2**32]`` with 64-bit mode
  off (``prng.prng_key``);
* :func:`threefry2x32` is the Threefry-2x32 block cipher with 20 rounds
  (``jax/_src/prng.py``, ``_threefry2x32_lowering``): key schedule
  ``k3 = k1 ^ k2 ^ 0x1BD11BDA``, rotations 13, 15, 26, 6 / 17, 29, 16, 24,
  an injection after every four rounds;
* the counters of a draw of shape ``S`` are the row-major flat indices of
  its output as 64-bit values split into (hi, lo) words
  (``iota_2x32_shape``), so a draw of more than 2**32 values stays right;
* :func:`split` is the fold-like split: key ``i`` of ``num`` is the pair
  ``threefry2x32(key, (0, i))``;
* :func:`random_bits32` is ``bits1 ^ bits2`` of ``threefry2x32(key, counters)``;
* :func:`randint` (``jax/_src/random.py``, ``_randint``) splits its key in
  two, draws ``higher`` and ``lower`` from the halves and reduces them with
  the span in wrapping uint32 arithmetic;
* :func:`uniform` sets the top 23 bits of a draw as a float32 mantissa in
  [1, 2), subtracts 1 and scales;
* :func:`fold_in` is ``threefry2x32(key, (0, d))``, which is also
  ``split(key, d + 1)[d]``;
* :func:`categorical_masked` is ``jax.random.categorical`` over logits of
  0 where a mask is true and -inf where it is false: Gumbel noise
  ``-log(-log(u))`` plus the logits, then the first argmax.  ``u`` is
  ``uniform(minval=tiny)``, a strictly increasing function of the draw's
  top 23 bits, and XLA's ``-log(-log(u))`` is strictly increasing over all
  2**23 values ``u`` takes (``tests/test_torch_threefry.py`` checks it), so
  the draw is the first index of the largest ``bits >> 9`` among the
  allowed entries, and no logarithm is taken.  Float logarithms differ
  between XLA and torch (and the card), so that is the only exact route.

Values are int64 tensors holding uint32 (``sim/packbits`` explains why);
:func:`randint` returns int32 and :func:`uniform` float32, as the JAX calls
the engines make do.  Each draw follows its key's device: a CPU key takes
the plain PyTorch version in this module, a CUDA key launches the
hand-written Hopper kernel T1 (``ops/threefry_kernel.py``,
``csrc/threefry.cu``) once per call or raises — never a fallback; the
categorical draw is that file's kernel C1.  The
plain version of one threefry2x32 is about 150 launches; the kernel reads
the key on the card, so a draw adds no host sync.
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

from ringpop_tpu_torch.ops import threefry_kernel
from ringpop_tpu_torch.ops.threefry_kernel import span_multiplier
from ringpop_tpu_torch.sim.packbits import M32, as_i32

KS_PARITY = 0x1BD1_1BDA  # the Threefry key-schedule constant
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(int(d) for d in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x1, x2)`` under the
    key ``(k1, k2)``: int64 tensors (or ints) holding uint32, broadcast
    together.  Returns the two output words as int64 holding uint32."""
    ks = (k1 & M32, k2 & M32, (k1 ^ k2 ^ KS_PARITY) & M32)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def counters(shape: Shape, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int64[*shape]: the row-major flat index of each output
    element as a 64-bit value, split into its uint32 words."""
    shape = _shape(shape)
    flat = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return (flat >> 32).reshape(shape), (flat & M32).reshape(shape)


def _check_key(key: torch.Tensor, what: str) -> None:
    if key.dtype != torch.int64 or key.shape != (2,):
        raise ValueError(f"{what} takes a raw key int64[2], got {key.dtype}{list(key.shape)}")


def _bits_plain(key: torch.Tensor, shape: tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    hi, lo = counters(shape, key.device)
    return threefry2x32(key[0], key[1], hi, lo)


def split_plain(key: torch.Tensor, num: int) -> torch.Tensor:
    """The plain version of :func:`split`."""
    b1, b2 = _bits_plain(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def random_bits32_plain(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """The plain version of :func:`random_bits32`."""
    b1, b2 = _bits_plain(key, _shape(shape))
    return b1 ^ b2


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``a * b mod 2**32`` for ``a`` int64 holding uint32 and ``b`` < 2**32,
    in two 16-bit halves so no product passes 2**48."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & M32


def randint_from_bits(higher: torch.Tensor, lower: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """int32 ``lo + (((higher % span) * multiplier + lower % span) % span)``
    with every step in wrapping uint32, from the two bit streams (int64
    holding uint32)."""
    span, mult = span_multiplier(lo, hi)
    offset = ((_mul32(higher % span, mult) + lower % span) & M32) % span
    return as_i32((lo + offset) & M32)


def randint_plain(key: torch.Tensor, shape: Shape, lo: int, hi: int) -> torch.Tensor:
    """The plain version of :func:`randint`."""
    keys = split_plain(key, 2)
    shape = _shape(shape)
    return randint_from_bits(random_bits32_plain(keys[0], shape), random_bits32_plain(keys[1], shape), lo, hi)


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 in [minval, maxval) from 32 random bits (int64 holding
    uint32): ``max(minval, f * (maxval - minval) + minval)``, where ``f``
    is the bits' top 23 as a mantissa in [1, 2), less 1.  XLA contracts the
    scale and shift into one fused multiply-add, rounded once to float32;
    here the product is exact in float64 and the sum is rounded to float64
    and then to float32 (exact for the engines' [0, 1), where it is ``f``)."""
    f = ((bits >> 9) | 0x3F80_0000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    scaled = (f.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, scaled)


def uniform_plain(key: torch.Tensor, shape: Shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """The plain version of :func:`uniform`."""
    return uniform_from_bits(random_bits32_plain(key, shape), minval, maxval)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: int64[num, 2], key ``i`` =
    ``threefry2x32(key, (0, i))``."""
    _check_key(key, "split")
    if key.device.type == "cpu":
        return split_plain(key, num)
    return threefry_kernel.split_cuda(key, num)


def random_bits32(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int64[*shape] holding uint32."""
    _check_key(key, "random_bits32")
    if key.device.type == "cpu":
        return random_bits32_plain(key, shape)
    return threefry_kernel.bits_cuda(key, _shape(shape))


def randint(key: torch.Tensor, shape: Shape, lo: int, hi: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, lo, hi, dtype=int32)`` for int32
    bounds: int32[*shape] in [lo, hi) (``lo`` everywhere when hi <= lo)."""
    _check_key(key, "randint")
    if key.device.type == "cpu":
        return randint_plain(key, shape, lo, hi)
    return threefry_kernel.randint_cuda(key, _shape(shape), lo, hi)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    _check_key(key, "uniform")
    if key.device.type == "cpu":
        return uniform_plain(key, shape, minval, maxval)
    return threefry_kernel.uniform_cuda(key, _shape(shape), minval, maxval)


def fold_in_plain(key: torch.Tensor, data: int) -> torch.Tensor:
    """The plain version of :func:`fold_in`."""
    return torch.stack(threefry2x32(key[0], key[1], 0, data))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``: the key
    int64[2] ``threefry2x32(key, (0, data))``."""
    _check_key(key, "fold_in")
    if not 0 <= data < 2**32:
        raise ValueError(f"fold_in takes data in [0, 2**32), got {data}")
    if key.device.type == "cpu":
        return fold_in_plain(key, data)
    return threefry_kernel.fold_in_cuda(key, data)


# elements of one chunk of the plain categorical draw
CATEGORICAL_CHUNK = 1 << 22


def _check_mask(mask: torch.Tensor, reps) -> None:
    if mask.dtype != torch.bool:
        raise TypeError(
            "categorical_masked takes a bool mask: logits of 0 where it is true "
            f"and -inf where it is false; general logits ({mask.dtype}) are not supported")
    if mask.dim() != 2:
        raise ValueError(f"categorical_masked takes a mask [R, N], got {list(mask.shape)}")
    if reps is not None and int(reps) < 1:
        raise ValueError(f"reps must be at least 1, got {reps}")


def categorical_masked_plain(key: torch.Tensor, mask: torch.Tensor, reps=None, rows=None) -> torch.Tensor:
    """The plain version of :func:`categorical_masked`.  The bits are drawn
    a chunk of rows at a time on explicit (hi, lo) counters, the flat index
    of each element in the whole ``[R, N]`` or ``[R, reps, N]`` draw, so
    ``rows`` (int64 row indices) draws only those rows of it."""
    n_rows, n = mask.shape
    r = 1 if reps is None else int(reps)
    dev = mask.device
    rows = torch.arange(n_rows, device=dev) if rows is None else torch.as_tensor(rows, dtype=torch.int64, device=dev)
    out = torch.empty((rows.numel(), r), dtype=torch.int32, device=dev)
    step = max(1, CATEGORICAL_CHUNK // max(1, r * n))
    cols = torch.arange(n, dtype=torch.int64, device=dev)
    for start in range(0, rows.numel(), step):
        rc = rows[start:start + step]
        flat = ((rc[:, None, None] * r + torch.arange(r, device=dev)[None, :, None]) * n + cols)
        b1, b2 = threefry2x32(key[0], key[1], flat >> 32, flat & M32)
        allowed = mask[rc]
        allowed = (allowed | ~allowed.any(dim=1, keepdim=True))[:, None, :]
        val = torch.where(allowed, (b1 ^ b2) >> 9, -1)
        out[start:start + step] = val.argmax(dim=-1).to(torch.int32)
    return out[:, 0] if reps is None else out


def categorical_masked(key: torch.Tensor, mask: torch.Tensor, reps=None) -> torch.Tensor:
    """``jax.random.categorical(key, where(mask, 0, -inf), axis=-1)`` for a
    bool ``mask[R, N]``: int32[R], one index a row drawn among its true
    entries (a row with none draws over the whole row, as the engines' safe
    logits do), ties to the first index.  With ``reps=r`` it is
    ``categorical(key, logits[:, None, :], shape=(R, r))``: int32[R, r]
    from the ``[R, r, N]`` draw."""
    _check_key(key, "categorical_masked")
    _check_mask(mask, reps)
    if key.device.type == "cpu":
        return categorical_masked_plain(key, mask, reps)
    return threefry_kernel.categorical_cuda(key, mask, reps)
