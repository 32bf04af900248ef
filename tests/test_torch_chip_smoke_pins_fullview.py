"""The JAX pins of ``chip_smoke.py``'s phase 13 (the exact full-view engine),
recomputed.

``chip_smoke.py`` imports nothing of JAX, so the tick count and final-leaf
digests it holds the port's ``FullViewSim`` to are constants.  Here they
are recomputed on the CPU from ``ringpop_tpu.sim.fullview`` on its own
threefry draws: BASELINE config 2's shape (``cli/simbench.py:bench_loss1k``:
1000 nodes, 10 victims of ``default_rng(0)``, 5 % loss, suspect_ticks 25)
run until every live node holds every victim Faulty (``fv_detected`` of
``tests/engine_agreement.py``), checked every tick; and the same recipe at
4096 nodes (41 victims) for 16 ticks.  A file of its own, so that a worker
of its own takes the ~20 s run at 4096.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.sim import fullview as jfv
from ringpop_tpu_torch.sim import fullview as tfv
from tests.engine_agreement import fv_detected


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _digests(state):
    return chip_smoke.leaf_digests(jax.tree_util.tree_map(np.asarray, state), jfv.FullViewState._fields)


def _port_view(sim):
    """The JAX state as the port's, for chip_smoke's own copy of the query."""
    return tfv.state_from_numpy(tfv.FullViewParams(n=sim.params.n), jax.tree_util.tree_map(np.asarray, sim.state),
                                device="cpu")


def _sim(n, count):
    victims = chip_smoke.fullview_victims(n, count)
    up = np.ones(n, bool)
    up[victims] = False
    sim = jfv.FullViewSim(n=n, seed=0, suspect_ticks=chip_smoke.FV_SUSPECT_TICKS)
    return sim, victims, up, jfv.Faults(up=jnp.asarray(up), drop_rate=chip_smoke.FV_LOSS_DROP)


def test_phase13b_loss1k_pins_match_the_jax_package():
    sim, victims, up, faults = _sim(chip_smoke.FV_LOSS_N, chip_smoke.FV_LOSS_VICTIMS)
    # the query chip_smoke keeps in its own copy, on the JAX state
    assert chip_smoke.fv_detected(_port_view(sim), victims, up) == fv_detected(sim, victims, up)
    ticks = 0
    while ticks < chip_smoke.FV_MAX_TICKS and not fv_detected(sim, victims, up):
        sim.tick(faults)
        ticks += 1
        assert chip_smoke.fv_detected(_port_view(sim), victims, up) == fv_detected(sim, victims, up)
    assert ticks == chip_smoke.PIN_FV_LOSS_TICKS
    assert _digests(sim.state) == chip_smoke.PIN_FV_LOSS


def test_phase13c_4096_pins_match_the_jax_package():
    sim, victims, up, faults = _sim(chip_smoke.FV_BIG_N, chip_smoke.FV_BIG_VICTIMS)
    for _ in range(chip_smoke.FV_BIG_TICKS):
        sim.tick(faults)
    assert _digests(sim.state) == chip_smoke.PIN_FV_BIG
    # not a vacuous run: suspicion has spread, detection is not complete
    assert (np.asarray(sim.state.status) == 1).sum() > 0 and not fv_detected(sim, victims, up)
