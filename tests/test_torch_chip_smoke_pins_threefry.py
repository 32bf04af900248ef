"""The JAX pins of ``chip_smoke.py``'s phase 11 (bench.py's own stream,
threefry), recomputed.

``chip_smoke.py`` imports nothing of JAX, so the tick counts, final-leaf
digests and checksums it holds the bench twin to are constants.  Here they
are recomputed on the CPU from the JAX package at its default stream: the
delta engine at bench.py's delta configuration (1,000,000 x 128, shift,
``run_until_converged(max_ticks=4096, check_every=8)`` from
``init_state(seed=1)``) and phase 7's uniform exchange with 1000 nodes down
and ``drop_rate=0.01`` for 24 ticks; the lifecycle engine at bench.py's
headline (1,000,000 x 256, its 1000 victims down, seed 0): the leaves after
the first 8 ticks, then ``LifecycleSim.run_until_detected`` and
``run_until_converged(max_ticks=4096, check_every=32,
blocks_per_dispatch=8)``, the final leaves and ``view_checksums``.  The
phase 9 pins at ``rng="counter"`` are recomputed by
``test_torch_chip_smoke_pins.py``; this file is apart so that a worker of
its own takes the second 1M x 256 run.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke
from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim import lifecycle as jl


def _digests(state, fields):
    return chip_smoke.leaf_digests(jax.tree_util.tree_map(np.asarray, state), fields)


def _headline():
    n = chip_smoke.LIFE_N
    victims = chip_smoke.headline_victims(n)
    up = np.ones(n, bool)
    up[victims] = False
    return victims, jd.DeltaFaults(up=jnp.asarray(up))


def test_phase11_delta_pins_match_the_jax_package():
    p = jd.DeltaParams(n=chip_smoke.DELTA_N, k=chip_smoke.DELTA_K)
    assert p.rng == "threefry" and p.exchange == "shift"
    state, ticks, ok = jd.run_until_converged(
        p, jd.init_state(p, seed=chip_smoke.DELTA_SEED),
        max_ticks=chip_smoke.DELTA_MAX_TICKS, check_every=chip_smoke.DELTA_CHECK_EVERY)
    assert ok and ticks == chip_smoke.PIN_TF_DELTA_TICKS
    assert _digests(state, jd.DeltaState._fields) == chip_smoke.PIN_TF_DELTA


def test_phase11_uniform_pins_match_the_jax_package():
    n = chip_smoke.DELTA_N
    p = jd.DeltaParams(n=n, k=chip_smoke.DELTA_K, exchange="uniform")
    up = np.ones(n, bool)
    up[chip_smoke.uniform_down_nodes(n)] = False
    faults = jd.DeltaFaults(up=jnp.asarray(up), drop_rate=jnp.float32(chip_smoke.UNIFORM_DROP))
    state = jd.init_state(p, seed=chip_smoke.DELTA_SEED)
    step = jax.jit(lambda s, f: jd.step(p, s, f))
    for _ in range(chip_smoke.UNIFORM_TICKS):
        state = step(state, faults)
    assert _digests(state, jd.DeltaState._fields) == chip_smoke.PIN_TF_UNIFORM
    assert bool(jd.converged(state, faults))


def test_phase11_first_ticks_pins_match_the_jax_package():
    _, faults = _headline()
    p = jl.LifecycleParams(n=chip_smoke.LIFE_N, k=chip_smoke.LIFE_K)
    state = jl.init_state(p, seed=chip_smoke.LIFE_SEED)
    step = jax.jit(lambda s, f: jl.step(p, s, f))
    for _ in range(chip_smoke.LIFE_TWIN_TICKS):
        state = step(state, faults)
    assert _digests(state, jl.LifecycleState._fields) == chip_smoke.PIN_TF_LIFE_TWIN


def test_phase11_headline_pins_match_the_jax_package():
    """bench.py's headline at its own stream through the JAX package's entry
    points (the full run: about 70 s on the CPU)."""
    victims, faults = _headline()
    sim = jl.LifecycleSim(n=chip_smoke.LIFE_N, k=chip_smoke.LIFE_K, seed=chip_smoke.LIFE_SEED)
    assert sim.params.rng == "threefry"
    run = dict(max_ticks=chip_smoke.LIFE_MAX_TICKS, check_every=chip_smoke.LIFE_CHECK_EVERY,
               blocks_per_dispatch=8)
    assert sim.run_until_detected(victims, faults, **run) == (chip_smoke.PIN_TF_LIFE_DETECT_TICKS, True)
    assert sim.run_until_converged(faults, **run) == (chip_smoke.PIN_TF_LIFE_CONVERGE_TICKS, True)
    assert _digests(sim.state, jl.LifecycleState._fields) == chip_smoke.PIN_TF_LIFE
    cs = np.asarray(jl.view_checksums(sim.state, faults))
    assert cs.dtype == np.uint32
    assert int(cs.astype(np.uint64).sum() % 2**32) == chip_smoke.PIN_TF_LIFE_VIEWS_SUM
    assert hashlib.sha256(cs.astype("<u4").tobytes()).hexdigest() == chip_smoke.PIN_TF_LIFE_VIEWS_SHA
