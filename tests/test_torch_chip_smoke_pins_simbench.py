"""The JAX pins of ``chip_smoke.py``'s phase 24 (the simbench twin's rows at
full scale on the card), recomputed, and the phase's row list and pin keys
held to the twin.

``chip_smoke.py`` imports nothing of JAX, so what it holds the port to on
the card is a constant: ``PIN_SIMBENCH[row]["record"]``, every field of
the JAX package's full-scale record but those ``SIMBENCH_INEXACT`` names
(walls, rates, the description of a twin's devices), and
``PIN_SIMBENCH[row]["digests"]``, the ``tree_digest`` of each final engine
state the row ends with (the JAX side's ``LifecycleSim`` recorded through
a wrapper); ``PIN_STEP1M``, the digest after the one 1M x 256 step of
``sharded100k``'s ``step1m`` leg.  Here the JAX package computes them
(``-m slow``, minutes: ``partition_lc`` runs 1,000,000 x 256 to detection
and convergence).  ``delta16m``'s 16,000,000 x 64 run takes ~17 GB of host
memory in the JAX engine, more than a test may take, so its record pins
only the configuration and the phase holds its ticks and digest to the
port's plain version on the card; ``ring1m``'s owners are held to the host
oracle there.

In tier-1: the phase's rows are the twin's, each pinned field is a key of
its row's record, and ``loss1k`` and ``flap1k``, whose full scale is their
only scale, run through the port on the CPU equal to their pins.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.cli import simbench as jsb
from ringpop_tpu.sim import lifecycle as jlifecycle, telemetry as jtelemetry
from ringpop_tpu_torch.cli import simbench as tsb
from ringpop_tpu_torch.sim import telemetry as ttelemetry

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_row_pin(row: str) -> dict:
    """The JAX package's full-scale record of ``row`` without its inexact
    fields, and the digests of the final states of the ``LifecycleSim``s it
    made."""
    made = []
    real = jlifecycle.LifecycleSim

    class Recording(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    jlifecycle.LifecycleSim = Recording
    try:
        record = jsb.BENCHES[row](chip_smoke.SIMBENCH_SEED, True)
    finally:
        jlifecycle.LifecycleSim = real
    digests = [int(jtelemetry.tree_digest(s.state)) for s in made]
    return {"record": chip_smoke.simbench_strip(record, chip_smoke.SIMBENCH_INEXACT[row]), "digests": digests}


def jax_step1m_digest() -> dict:
    """The unsharded JAX step ``step1m`` makes: 1,000,000 x 256, counter,
    ``suspect_ticks`` 10, every 1000th node down, one tick from the
    row's seed."""
    from ringpop_tpu.sim.delta import DeltaFaults

    n, k = chip_smoke.STEP1M_N, chip_smoke.STEP1M_K
    params = jlifecycle.LifecycleParams(n=n, k=k, suspect_ticks=10, rng="counter")
    up = np.ones(n, bool)
    up[::1000] = False
    state = jlifecycle._run_block(params, jlifecycle.init_state(params, seed=chip_smoke.SIMBENCH_SEED),
                                  DeltaFaults(up=jnp.asarray(up)), ticks=1)
    return {"tick": int(state.tick), "digest": int(jtelemetry.tree_digest(state))}


def test_phase_rows_and_pin_keys_are_the_twins():
    assert set(chip_smoke.SIMBENCH_ROWS) <= set(tsb.BENCHES)
    assert set(chip_smoke.PIN_SIMBENCH) == set(chip_smoke.SIMBENCH_ROWS) == set(chip_smoke.SIMBENCH_INEXACT)
    for row in chip_smoke.SIMBENCH_ROWS:
        src = inspect.getsource(tsb.BENCHES[row])
        if row in ("flap1k", "asym_partition"):
            src += inspect.getsource(tsb._run_chaos_scenario) + inspect.getsource(tsb.chaos_twins)
        for key in [*chip_smoke.PIN_SIMBENCH[row]["record"], *(p.split(".")[-1] for p in
                                                              chip_smoke.SIMBENCH_INEXACT[row])]:
            assert f'"{key}"' in src or f"{key}=" in src, (row, key)
    assert chip_smoke.STEP1M_N == tsb.STEP1M["n"] and chip_smoke.STEP1M_K == tsb.STEP1M["k"]


@pytest.mark.parametrize("row", ["loss1k", "flap1k"])
def test_rows_whose_full_scale_is_their_only_scale_equal_their_pins_on_the_cpu(row, monkeypatch):
    twins = chip_smoke.PIN_CHAOS_TWIN
    if row == "flap1k":  # the twin's certificate is PIN_CHAOS_TWIN's plan, held by the chaos tests
        spec = tsb._twin_spec("flap", chip_smoke.SIMBENCH_SEED)
        monkeypatch.setitem(tsb._TWIN_MEMO, ("cpu", spec), {
            "digest_unsharded": twins["flap"]["digest"], "digest_sharded": twins["flap"]["digest"], "equal": True,
            "n": 4096, "k": 64, "ticks": 24, "mesh": "4x2 (node x rumor), from the pins"})
    record = tsb.BENCHES[row](chip_smoke.SIMBENCH_SEED, True, device=CPU)
    pin = chip_smoke.PIN_SIMBENCH[row]
    assert chip_smoke.simbench_strip(record, chip_smoke.SIMBENCH_INEXACT[row]) == pin["record"]
    assert [int(ttelemetry.tree_digest(s)) for s in tsb.LAST_RUN[row]["states"]] == pin["digests"]


@pytest.mark.slow
@pytest.mark.parametrize("row", ["loss1k", "sweep100k", "partition_lc", "flap1k", "asym_partition", "ring1m"])
def test_jax_row_pins(row):
    assert jax_row_pin(row) == chip_smoke.PIN_SIMBENCH[row]


@pytest.mark.slow
def test_jax_step1m_pin():
    assert jax_step1m_digest() == chip_smoke.PIN_STEP1M


def test_twin_pins_are_the_chaos_twin_pins():
    for row, plan in (("flap1k", "flap"), ("asym_partition", "asym")):
        twin = chip_smoke.PIN_SIMBENCH[row]["record"]["sharded_twin"]
        assert twin["digest_unsharded"] == twin["digest_sharded"] == chip_smoke.PIN_CHAOS_TWIN[plan]["digest"]
        assert twin["equal"] is True
