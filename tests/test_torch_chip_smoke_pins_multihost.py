"""The JAX pins of ``chip_smoke.py``'s phase 20 (simbench ``multihost16m`` over
the port's TCP fabric), recomputed.

``chip_smoke.py`` imports nothing of JAX, so what it holds the port to on the
card is constants.  Here the JAX package computes them on the CPU:

* ``PIN_MH_TWIN`` — ``_MH_TWIN`` (65,536 x 64, 24 ticks, 64 victims drawn
  from ``seed + 999``, loss 0.05, seed 0): the engine's ``tree_digest``, and
  the JAX ``MultihostDelta``'s at P = 1; the port's own ``delta.step``
  through ``chip_smoke``'s recipe on the CPU gives the same;
* ``PIN_MH_SNAPSHOT`` — the snapshot leg (victims, no loss): the digest at
  tick 16 (the save) and at tick 24 (the unbroken run the restore continues
  to);
* ``PIN_MH_SCALE`` — 16,000,000 x 64 ``run_until_converged`` from seed 0
  (``-m slow``: the JAX engine's peak is ~17 GB of host memory).  The
  committed ``SIMBENCH_r08.json`` record of the JAX package's run holds the
  same numbers, checked here in tier-1.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.parallel.fabric import Fabric, LocalKV
from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim.delta_multihost import MultihostDelta
from ringpop_tpu.sim.telemetry import tree_digest

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def twin_faults(drop: bool):
    t = chip_smoke.MH_TWIN
    rng = np.random.default_rng(t["seed"] + 999)
    up = np.ones(t["n"], bool)
    up[rng.choice(t["n"], size=t["victims"], replace=False)] = False
    return jd.DeltaFaults(up=jnp.asarray(up), **({"drop_rate": jnp.float32(t["drop"])} if drop else {}))


def test_pin_mh_twin():
    t = chip_smoke.MH_TWIN
    params = jd.DeltaParams(n=t["n"], k=t["k"], rng="counter")
    faults = twin_faults(drop=True)
    stp = jax.jit(functools.partial(jd.step, params))
    st = jd.init_state(params, seed=t["seed"])
    for _ in range(t["ticks"]):
        st = stp(st, faults)
    assert int(tree_digest(st)) == chip_smoke.PIN_MH_TWIN
    with Fabric(0, 1, LocalKV()) as fab:
        mh = MultihostDelta(params, fab, seed=t["seed"], faults=faults)
        for _ in range(t["ticks"]):
            mh.step()
        assert mh.state_digest() == chip_smoke.PIN_MH_TWIN
    assert chip_smoke.mh_engine_digest(torch.device("cpu")) == chip_smoke.PIN_MH_TWIN


def test_pin_mh_snapshot():
    t = chip_smoke.MH_TWIN
    params = jd.DeltaParams(n=t["n"], k=t["k"], rng="counter")
    faults = twin_faults(drop=False)
    stp = jax.jit(functools.partial(jd.step, params))
    st = jd.init_state(params, seed=t["seed"])
    digests = {}
    for tick in range(1, chip_smoke.MH_SAVE_TICKS + chip_smoke.MH_EXTRA_TICKS + 1):
        st = stp(st, faults)
        digests[tick] = int(tree_digest(st))
    assert digests[chip_smoke.MH_SAVE_TICKS] == chip_smoke.PIN_MH_SNAPSHOT["at_save"]
    assert digests[chip_smoke.MH_SAVE_TICKS + chip_smoke.MH_EXTRA_TICKS] == chip_smoke.PIN_MH_SNAPSHOT["continued"]


def test_pins_equal_the_jax_packages_multihost16m_record():
    """The committed record of the JAX package's own multihost16m run at
    full scale (``SIMBENCH_r08.json``) holds the same three pins."""
    rec = next(s for s in json.loads((REPO / "SIMBENCH_r08.json").read_text())["scenarios"]
               if s["metric"] == "multihost_dcn_16m")
    assert rec["engine_digest"] == chip_smoke.PIN_MH_TWIN
    assert rec["snapshot"]["digest_at_save"] == chip_smoke.PIN_MH_SNAPSHOT["at_save"]
    assert rec["snapshot"]["digest_unbroken_reference"] == chip_smoke.PIN_MH_SNAPSHOT["continued"]
    assert rec["n_nodes"] == chip_smoke.MH_SCALE_N and rec["n_rumors"] == chip_smoke.MH_SCALE_K
    for p in ("1", "2"):
        assert rec["scale"][p]["ticks"] == chip_smoke.PIN_MH_SCALE["ticks"]
        assert rec["scale"][p]["digest"] == chip_smoke.PIN_MH_SCALE["digest"]


@pytest.mark.slow
def test_pin_mh_scale():
    params = jd.DeltaParams(n=chip_smoke.MH_SCALE_N, k=chip_smoke.MH_SCALE_K, rng="counter")
    st = jd.init_state(params, seed=chip_smoke.MH_TWIN["seed"])
    st, ticks, ok = jd.run_until_converged(params, st, jd.DeltaFaults(), max_ticks=4096, check_every=1)
    assert ok and ticks == chip_smoke.PIN_MH_SCALE["ticks"]
    assert int(tree_digest(st)) == chip_smoke.PIN_MH_SCALE["digest"]
