"""The counter stream: PyTorch port against the JAX package.

``ringpop_tpu_torch.sim.prng`` draws equal ``ringpop_tpu.sim.prng``'s over
(seed, tick, site, lane) grids that take in every ``D_*`` site id, negative
seeds, seeds >= 2**32, ticks and lanes across 2**31, and broadcasting;
``prng_key`` equals ``jax.random.PRNGKey`` (64-bit mode off) over the same
seeds.  Values cross as int64 holding uint32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import prng as jr

from ringpop_tpu_torch.sim import prng as tr

SEEDS = [0, 1, 7, -1, -2, -(1 << 31), -(1 << 31) - 1, (1 << 31) - 1, 1 << 31,
         (1 << 32) - 1, 1 << 32, (1 << 32) + 3, 1 << 33, 12_345_678_901, -98_765_432_109]
SITES = sorted({v for k, v in vars(jr).items() if k.startswith("D_") and k != "D_COLUMN_SPAN"}
               | {jr.D_PEER + 1, jr.D_PEER + 7, jr.D_PEER_DROP_ACK + 3, jr.D_TOPO_PEER_ACK + 255})
TICKS = [0, 1, 2, 17, 4095, (1 << 31) - 1]
LANES = np.concatenate([np.arange(2000), [1 << 20, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]]).astype(np.uint32)


def test_site_ids_verbatim():
    names = [k for k in vars(jr) if k.startswith("D_")]
    assert len(names) == 13
    for name in names:
        assert getattr(tr, name) == getattr(jr, name), name
    assert tr._GAMMA == jr._GAMMA


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_key_match_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed))
    key = tr.prng_key(seed, device="cpu")
    assert key.dtype == torch.int64 and key.shape == (2,)
    assert np.array_equal(key.numpy(), want.astype(np.int64))
    assert int(tr.fold_key(key)) == int(jr.fold_key(jnp.asarray(want)))


@pytest.mark.parametrize("tick", TICKS)
def test_draws_match_jax_over_the_grid(tick):
    lanes_t = torch.from_numpy(LANES.astype(np.int64))
    lanes_j = jnp.asarray(LANES)
    for seed in SEEDS[::3]:
        key = np.asarray(jax.random.PRNGKey(seed))
        jseed = jr.fold_key(jnp.asarray(key))
        tseed = tr.fold_key(torch.from_numpy(key.astype(np.int64)))
        jtick = jnp.asarray(tick, jnp.int32)
        ttick = torch.tensor(tick, dtype=torch.int32)
        for site in SITES:
            u = tr.draw_u32(tseed, ttick, site, lanes_t)
            assert u.dtype == torch.int64
            assert np.array_equal(u.numpy(), np.asarray(jr.draw_u32(jseed, jtick, site, lanes_j)).astype(np.int64))
            f = tr.draw_uniform(tseed, ttick, site, lanes_t)
            assert f.dtype == torch.float32
            assert np.array_equal(f.numpy(), np.asarray(jr.draw_uniform(jseed, jtick, site, lanes_j)))
            assert float(f.max()) < 1.0 and float(f.min()) >= 0.0


@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 999), (1, 1_000_000), (0, 4095), (-5, 5),
                                   (-(1 << 31), (1 << 31) - 1), (0, (1 << 31) - 1)])
def test_randint_matches_jax(lo, hi):
    lanes = np.arange(5000, dtype=np.int32)
    for tick in (0, 3, 77):
        seed = jr.fold_key(jax.random.PRNGKey(tick + 11))
        want = np.asarray(jr.draw_randint(seed, jnp.int32(tick), jr.D_TARGET, jnp.asarray(lanes), lo, hi))
        got = tr.draw_randint(torch.tensor(int(seed)), torch.tensor(tick, dtype=torch.int32), tr.D_TARGET,
                              torch.from_numpy(lanes), lo, hi)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        assert int(got.min()) >= lo and int(got.max()) < hi
    # a scalar lane (the shift draw) gives a 0-d int32
    s = tr.draw_randint(torch.tensor(int(seed)), torch.tensor(5, dtype=torch.int32), tr.D_SHIFT, 0, lo, hi)
    assert s.shape == () and int(s) == int(jr.draw_randint(seed, jnp.int32(5), jr.D_SHIFT, 0, lo, hi))
    with pytest.raises(ValueError, match="empty"):
        tr.draw_randint(0, 0, 0, 0, hi, lo)


def test_draws_broadcast_like_jax():
    """Lanes [L, 1] against sites [1, S], and Python-int scalars: the same
    broadcast shape and values as the JAX originals."""
    lanes = np.arange(300, dtype=np.uint32)[:, None]
    sites = np.array([tr.D_PEER + j for j in range(6)], np.uint32)[None, :]
    want = np.asarray(jr.draw_u32(jnp.uint32(99), jnp.int32(4), jnp.asarray(sites), jnp.asarray(lanes)))
    got = tr.draw_u32(99, 4, torch.from_numpy(sites.astype(np.int64)), torch.from_numpy(lanes.astype(np.int64)))
    assert got.shape == (300, 6) and np.array_equal(got.numpy(), want.astype(np.int64))
    assert int(tr.draw_u32(1, 2, 3, 4)) == int(jr.draw_u32(1, 2, 3, 4))


def test_uint32_tensors_without_uint32_shift():
    """torch.uint32 has no ``>>`` on the CPU build: the stream widens every
    operand to int64 first, so uint32 and int32 inputs give the same draws."""
    lanes = np.array([0, 1, (1 << 31) + 5, (1 << 32) - 1], np.uint32)
    want = np.asarray(jr.draw_u32(jnp.uint32(5), jnp.uint32(6), jr.D_DROP, jnp.asarray(lanes))).astype(np.int64)
    for t in (torch.from_numpy(lanes), torch.from_numpy(lanes.view(np.int32)), torch.from_numpy(lanes.astype(np.int64))):
        assert np.array_equal(tr.draw_u32(5, 6, tr.D_DROP, t).numpy(), want)


def test_prng_key_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.prng_key(1)
