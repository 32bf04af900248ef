"""The JAX pins of ``chip_smoke.py``'s sim phases, recomputed.

``chip_smoke.py`` runs on the card and imports nothing of JAX, so the tick
counts, final-leaf digests and checksums it holds the port's engines to are
constants.  Here they are recomputed on the CPU: from
``ringpop_tpu.sim.delta``, phase 6 (1,000,000 x 128, shift,
``run_until_converged(max_ticks=4096, check_every=8)`` from
``init_state(seed=1)``) and phase 7 (uniform, 1000 nodes down,
``drop_rate=0.01``, 24 ticks); from ``ringpop_tpu.sim.lifecycle``, phase 9
(bench.py's headline, 1,000,000 x 256 with 1000 nodes down, seed 0,
``rng="counter"``): the leaves after the first 8 ticks, and the tick counts
of ``run_until_detected`` and ``run_until_converged(max_ticks=4096,
check_every=32, blocks_per_dispatch=8)``, the final leaves and the
``view_checksums`` after them.  The full-scale headline (about 120 s of
JAX on the CPU) is marked ``slow``; the card holds the port to its pins
every run, and tier-1 runs the same recipe at 4096 x 256 through both
packages.  Also: importing ``chip_smoke`` has no side effects and loads no
JAX, and without a card the script exits non-zero and prints no result.
"""

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu_torch.sim import delta as td
from ringpop_tpu_torch.sim import lifecycle as tl


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = Path(__file__).resolve().parent.parent


def test_phase6_pins_match_the_jax_package():
    p = jd.DeltaParams(n=chip_smoke.DELTA_N, k=chip_smoke.DELTA_K, exchange="shift", rng="counter")
    state, ticks, ok = jd.run_until_converged(
        p, jd.init_state(p, seed=chip_smoke.DELTA_SEED),
        max_ticks=chip_smoke.DELTA_MAX_TICKS, check_every=chip_smoke.DELTA_CHECK_EVERY)
    assert ok and ticks == chip_smoke.PIN_SHIFT_TICKS
    assert chip_smoke.leaf_digests(jax.tree_util.tree_map(np.asarray, state)) == chip_smoke.PIN_SHIFT


def test_phase7_pins_match_the_jax_package():
    n = chip_smoke.DELTA_N
    p = jd.DeltaParams(n=n, k=chip_smoke.DELTA_K, exchange="uniform", rng="counter")
    up = np.ones(n, bool)
    up[chip_smoke.uniform_down_nodes(n)] = False
    assert up.sum() == n - chip_smoke.UNIFORM_DOWN
    faults = jd.DeltaFaults(up=jnp.asarray(up), drop_rate=jnp.float32(chip_smoke.UNIFORM_DROP))
    state = jd.init_state(p, seed=chip_smoke.DELTA_SEED)
    step = jax.jit(lambda s, f: jd.step(p, s, f))
    for _ in range(chip_smoke.UNIFORM_TICKS):
        state = step(state, faults)
    assert chip_smoke.leaf_digests(jax.tree_util.tree_map(np.asarray, state)) == chip_smoke.PIN_UNIFORM
    assert bool(jd.converged(state, faults))


def _headline():
    n = chip_smoke.LIFE_N
    victims = np.sort(np.random.default_rng(0).choice(n, size=chip_smoke.LIFE_VICTIMS, replace=False))
    assert np.array_equal(victims, chip_smoke.headline_victims(n))
    up = np.ones(n, bool)
    up[victims] = False
    return victims, jd.DeltaFaults(up=jnp.asarray(up))


def _digests(state):
    return chip_smoke.leaf_digests(jax.tree_util.tree_map(np.asarray, state), jl.LifecycleState._fields)


def test_phase9_first_ticks_pins_match_the_jax_package():
    victims, faults = _headline()
    p = jl.LifecycleParams(n=chip_smoke.LIFE_N, k=chip_smoke.LIFE_K, rng="counter", exchange="shift")
    state = jl.init_state(p, seed=chip_smoke.LIFE_SEED)
    step = jax.jit(lambda s, f: jl.step(p, s, f))
    for _ in range(chip_smoke.LIFE_TWIN_TICKS):
        state = step(state, faults)
    assert _digests(state) == chip_smoke.PIN_LIFE_TWIN


@pytest.mark.slow
def test_phase9_headline_pins_match_the_jax_package():
    """bench.py's headline through the JAX package's own entry points (the
    full run: about 120 s on the CPU, so ``slow``; the card holds the port
    to these pins every run, and the recipe runs at a small size below)."""
    victims, faults = _headline()
    sim = jl.LifecycleSim(n=chip_smoke.LIFE_N, k=chip_smoke.LIFE_K, seed=chip_smoke.LIFE_SEED, rng="counter")
    run = dict(max_ticks=chip_smoke.LIFE_MAX_TICKS, check_every=chip_smoke.LIFE_CHECK_EVERY,
               blocks_per_dispatch=8)
    assert sim.run_until_detected(victims, faults, **run) == (chip_smoke.PIN_LIFE_DETECT_TICKS, True)
    assert sim.run_until_converged(faults, **run) == (chip_smoke.PIN_LIFE_CONVERGE_TICKS, True)
    assert _digests(sim.state) == chip_smoke.PIN_LIFE
    cs = np.asarray(jl.view_checksums(sim.state, faults))
    assert cs.dtype == np.uint32
    assert int(jnp.asarray(cs).sum()) == int(cs.astype(np.uint64).sum() % 2**32) == chip_smoke.PIN_LIFE_VIEWS_SUM
    assert hashlib.sha256(cs.astype("<u4").tobytes()).hexdigest() == chip_smoke.PIN_LIFE_VIEWS_SHA


def headline_recipe(n: int, k: int, rng: str) -> None:
    """bench.py's headline recipe at ``n`` x ``k`` through both packages'
    entry points: the same seed, the victims drawn as bench.py draws them
    (0.1 % of the nodes, ``default_rng(0)``), ``run_until_detected``, then
    ``run_until_converged`` and ``view_checksums``.  Tick counts, final leaf
    digests and view checksums must be equal."""
    victims = np.sort(np.random.default_rng(0).choice(n, size=n // 1000, replace=False))
    up = np.ones(n, bool)
    up[victims] = False
    jf, tf = jd.DeltaFaults(up=jnp.asarray(up)), td.DeltaFaults(up=torch.from_numpy(up))
    jsim = jl.LifecycleSim(n=n, k=k, seed=chip_smoke.LIFE_SEED, rng=rng)
    tsim = tl.LifecycleSim(n=n, k=k, seed=chip_smoke.LIFE_SEED, rng=rng, device="cpu")
    run = dict(max_ticks=chip_smoke.LIFE_MAX_TICKS, check_every=chip_smoke.LIFE_CHECK_EVERY,
               blocks_per_dispatch=8)
    detect = jsim.run_until_detected(victims, jf, **run)
    assert detect[1] and tsim.run_until_detected(victims, tf, **run) == detect
    converge = jsim.run_until_converged(jf, **run)
    assert converge[1] and tsim.run_until_converged(tf, **run) == converge
    fields = jl.LifecycleState._fields
    assert chip_smoke.leaf_digests(tl.state_to_numpy(tsim.state), fields) == _digests(jsim.state)
    jcs = np.asarray(jl.view_checksums(jsim.state, jf))
    assert np.array_equal(jcs.astype(np.int64), tl.view_checksums(tsim.state, tf).numpy())


def test_phase9_headline_recipe_at_a_small_size():
    """Phase 9's recipe (counter stream) at 4096 x 256: what tier-1 keeps of
    the slow full-scale recomputation above."""
    headline_recipe(4096, chip_smoke.LIFE_K, "counter")


def test_chip_smoke_import_is_quiet_and_jax_free():
    code = (
        "import sys, chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'ringpop_tpu')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout == "", proc.stdout + proc.stderr


def test_chip_smoke_without_a_card_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            assert "ok" not in json.loads(line)
        except ValueError:
            pass
