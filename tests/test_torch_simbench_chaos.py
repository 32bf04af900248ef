"""The simbench twin's chaos rows against the JAX package's, on the CPU at
simbench's non-full sizes, seed 0: ``churn100k`` (8192 x 64), ``flap1k``
(1000 x 64) and ``asym_partition`` (4096 x 64), each 256 ticks under its
fault plan with telemetry, scored, with its sharded twin.

Every field of the two records is held equal but these:

- ``value``: the row's wall, host clock;
- ``sharded_twin.mesh``: the description of the twin's devices (the JAX
  package's 8 virtual CPU devices, the port's 8 rank processes).

The twin's digests and ``equal`` are held like every other field.  The
port computes the four chaos twins (the three rows' plans and
``topo_chaos``'s topology smoke plan) in one group of 8 rank processes
first (``simbench.chaos_twins``), and each row takes its certificate from
that memo; the four are also held to ``chip_smoke.PIN_CHAOS_TWIN``, the
JAX package's digests of the same plans that
``tests/test_torch_rumor_axis_chaos.py`` recomputes.  Beside the records,
the rows' final states are held equal by their ``tree_digest``.
"""

import pytest
import torch

import chip_smoke
from ringpop_tpu.cli import simbench as jsb
from ringpop_tpu.sim import lifecycle as jlifecycle, telemetry as jtelemetry
from ringpop_tpu_torch.cli import simbench as tsb
from ringpop_tpu_torch.sim import telemetry as ttelemetry
from torch_simbench_compare import assert_rows_match

SEED = 0
CPU = torch.device("cpu")
INEXACT = {"value": "the row's wall, host clock",
           "sharded_twin.mesh": "names the twin's devices: virtual CPU devices against rank processes"}
TWINS = {"churn": "chaos", "flap": "chaos", "asym": "chaos", "smoke": "topo"}
PLANS = {"churn100k": "churn", "flap1k": "flap", "asym_partition": "asym"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_twins():
    specs = [tsb._twin_spec(name, SEED, builder=builder) for name, builder in TWINS.items()]
    return dict(zip(TWINS, tsb.chaos_twins(specs, device=CPU)))


@pytest.fixture
def jax_sims(monkeypatch):
    made = []

    class Recording(jlifecycle.LifecycleSim):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(jlifecycle, "LifecycleSim", Recording)
    return made


def test_the_four_twins_in_one_group_equal_the_pins(port_twins):
    assert chip_smoke.TWIN_SEED == SEED
    for name, twin in port_twins.items():
        pin = chip_smoke.PIN_CHAOS_TWIN[name]["digest"]
        assert twin["equal"] is True, twin
        assert twin["digest_unsharded"] == twin["digest_sharded"] == pin, (name, twin)
        assert (twin["n"], twin["k"], twin["ticks"]) == (chip_smoke.TWIN_N, chip_smoke.TWIN_K, chip_smoke.TWIN_TICKS)


@pytest.mark.parametrize("row", ["churn100k", "flap1k", "asym_partition"])
def test_chaos_row(row, port_twins, jax_sims):
    want = jsb.BENCHES[row](SEED, False)
    got = tsb.BENCHES[row](SEED, False, device=CPU)
    assert_rows_match(want, got, INEXACT)
    assert got["sharded_twin"] == port_twins[PLANS[row]]
    assert len(jax_sims) == 1
    assert int(jtelemetry.tree_digest(jax_sims[0].state)) == int(
        ttelemetry.tree_digest(tsb.LAST_RUN[row]["states"][0]))
