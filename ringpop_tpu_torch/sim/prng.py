"""Partition-invariant counter RNG for the sim engines (``rng="counter"``).

Counterpart of ``ringpop_tpu/sim/prng.py``, bit for bit: a value is
``h(seed, tick, draw-site, lane)``, where ``h`` is a chain of murmur3 fmix32
finalizers (``packbits.mix32``) — a per-site stream constant folded from
(seed, tick, site), then two fmix32 rounds over a Weyl walk of the lane
(the SplitMix construction).  Every draw is a pure function of its
coordinates: elementwise in the lane, stateless (the carried ``key`` leaf
holds the seed material and the tick advances the stream).  Not a
cryptographic generator, and not the JAX package's default threefry
stream.

Values are int64 tensors holding uint32 (``packbits`` explains why); all
arguments broadcast, and a Python int is taken mod 2**32 as
``.astype(uint32)`` takes it.
"""

from __future__ import annotations

import torch

from ringpop_tpu_torch.device import DeviceLike, resolve_device
from ringpop_tpu_torch.sim.packbits import M32, as_i32, as_u32, mix32

# the golden-ratio Weyl increment (2^32 / phi, odd): SplitMix's stream stride
_GAMMA = 0x9E37_79B9

# -- per-call-site draw ids (verbatim from the JAX package) -------------------
# One id per PRNG consumption site per tick, shared by the delta and
# lifecycle engines.  Multi-column sites add their column index to a base
# spaced D_COLUMN_SPAN apart, so a column index must stay below the span.
D_COLUMN_SPAN = 0x100
D_SHIFT = 1  # exchange="shift" cyclic offset (scalar)
D_TARGET = 2  # exchange="uniform" per-node targets
D_DROP = 3  # per-node packet-loss coin on the direct probe
D_HEAL_A = 4  # healer endpoint a (scalar)
D_HEAL_B = 5  # healer endpoint b (scalar)
D_HEAL_U = 6  # healer attempt coin (scalar)
D_TOPO = 7  # per-node topology tier-loss coin on the direct probe
D_PEER = 1 * D_COLUMN_SPAN  # + column j: indirect-probe peer choice [N, P]
D_PEER_DROP_REQ = 2 * D_COLUMN_SPAN  # + column j: ping-req request-leg loss [N, P]
D_PEER_DROP_ACK = 3 * D_COLUMN_SPAN  # + column j: ping-req ack-leg loss [N, P]
D_TOPO_PEER_REQ = 4 * D_COLUMN_SPAN  # + column j: tier-loss coin, ping-req request leg
D_TOPO_PEER_ACK = 5 * D_COLUMN_SPAN  # + column j: tier-loss coin, ping-req ack leg


def prng_key(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """The engines' ``key`` leaf for ``seed``: int64[2] holding the uint32
    pair that ``jax.random.PRNGKey(seed)`` gives with 64-bit mode off,
    ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=resolve_device(device))


def fold_key(key: torch.Tensor) -> torch.Tensor:
    """Scalar uint32 seed (int64 0-d) from an engine ``state.key`` leaf."""
    k = as_u32(key.reshape(-1))
    seed = torch.zeros((), dtype=torch.int64, device=key.device)
    for i in range(k.shape[0]):
        seed = mix32(seed ^ k[i] ^ ((i + 1) * _GAMMA & M32))
    return seed


def _device(*args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


def draw_u32(seed, tick, draw, lane) -> torch.Tensor:
    """uint32 ``h(seed, tick, draw, lane)`` as int64, elementwise in every
    argument (all broadcast; ``lane`` is normally the only array)."""
    dev = _device(lane, seed, tick, draw)
    stream = mix32(
        as_u32(seed, dev) ^ mix32(as_u32(tick, dev) ^ mix32((as_u32(draw, dev) * _GAMMA) & M32))
    )
    x = (as_u32(lane, dev) * _GAMMA + stream) & M32
    return mix32(mix32(x) ^ stream)


def draw_uniform(seed, tick, draw, lane) -> torch.Tensor:
    """float32 in [0, 1): the top 24 bits of the u32 draw times 2**-24
    (exact)."""
    u = draw_u32(seed, tick, draw, lane) >> 8
    return u.to(torch.float32) * (1.0 / (1 << 24))


def draw_randint(seed, tick, draw, lane, lo: int, hi: int) -> torch.Tensor:
    """int32 in [lo, hi) by modulo reduction (bias (hi-lo)/2**32), with the
    JAX package's int32 wrap."""
    span = hi - lo
    if span <= 0:
        raise ValueError(f"empty randint range [{lo}, {hi})")
    return as_i32((lo + draw_u32(seed, tick, draw, lane) % (span & M32)) & M32)
