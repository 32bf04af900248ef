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
  [1, 2), subtracts 1 and scales.

Values are int64 tensors holding uint32 (``sim/packbits`` explains why);
:func:`randint` returns int32 and :func:`uniform` float32, as the JAX calls
the engines make do.  Each draw follows its key's device: a CPU key takes
the plain PyTorch version in this module, a CUDA key launches the
hand-written Hopper kernel T1 (``ops/threefry_kernel.py``,
``csrc/threefry.cu``) once per call or raises — never a fallback.  The
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
