"""The JAX pins of ``chip_smoke.py``'s phase 21 (the serve plane's placement,
mesh and operations loop), recomputed.

``chip_smoke.py`` imports nothing of JAX, so what it holds the port to on the
card is constants.  Here the JAX package computes them on the CPU, through
the same views the script applies to the port's results:

* ``PIN_DGRO`` — simbench ``serve_ring``'s DGRO pass (64 servers x 100, 8
  candidates, 2**14 probes, churn 0.02, seed 0): every report field and the
  chosen ring's sha256; and a DGRO-placed ``RingStore`` as the game day
  builds it, through an update, a drain and a rescore: its records;
* ``PIN_FANIN`` — simbench ``serve_fanin``'s mesh at full scale at P = 1,
  2, 4, P = 4 with the codec off and traced: digests, message counts, wire
  and raw bytes a rank, and the sha256 of every rank's record;
* ``PIN_QUORUM`` — the quorum chaos harness at simbench's full setting;
* ``PIN_DGRO_1M`` (``-m slow``, ~16 s) — the pass at BASELINE config 5's
  ring (4096 x 256) with ``dgro_place``'s defaults;
* ``PIN_GAMEDAY`` (``-m slow``, ~50 s) — simbench ``gameday`` at full scale
  (zone cut and switch flap, n 128, horizon 64): both scenarios' digests
  (controller on, off and bare) and scorecards.

The port's own runs on the CPU land the same views for the tier-1 pins.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ringpop_tpu.forward.batch import quorum_chaos_run as jax_quorum_chaos_run
from ringpop_tpu.serve import placement as jp
from ringpop_tpu.serve.mesh import run_serve_mesh as jax_run_serve_mesh
from ringpop_tpu.serve.state import RingStore as JaxRingStore

from ringpop_tpu_torch.forward.batch import quorum_chaos_run
from ringpop_tpu_torch.serve import placement as tp
from ringpop_tpu_torch.serve.mesh import run_serve_mesh
from ringpop_tpu_torch.serve.state import RingStore


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dgro_pass(place, cfg, **kw):
    return chip_smoke.dgro_view(*place(cfg["servers"], cfg["points"], **cfg["kw"], **kw))


def test_pin_dgro():
    cfg = chip_smoke.DGRO_SERVE
    assert _dgro_pass(jp.dgro_place, cfg) == chip_smoke.PIN_DGRO["pass"]
    assert _dgro_pass(tp.dgro_place, cfg, device="cpu") == chip_smoke.PIN_DGRO["pass"]
    store = chip_smoke.DGRO_STORE
    kw = dict(replica_points=store["points"], placement="dgro", placement_kw=store["placement_kw"])
    assert chip_smoke.dgro_store_records(JaxRingStore(store["zones"], **kw)) == chip_smoke.PIN_DGRO["store"]
    assert (chip_smoke.dgro_store_records(RingStore(store["zones"], device="cpu", **kw))
            == chip_smoke.PIN_DGRO["store"])


@pytest.mark.parametrize("run", chip_smoke.FANIN_RUNS, ids=[r[0] for r in chip_smoke.FANIN_RUNS])
def test_pin_fanin(run):
    name, nprocs, kw = run
    pin = chip_smoke.PIN_FANIN[name]
    spans = []
    kw = {"trace_sink": spans.append} if kw is None else kw
    assert chip_smoke.fanin_view(jax_run_serve_mesh(nprocs, **chip_smoke.FANIN, **kw)) == pin
    assert chip_smoke.fanin_view(run_serve_mesh(nprocs, device="cpu", **chip_smoke.FANIN, **kw)) == pin
    assert pin["digests"] == chip_smoke.PIN_FANIN["P1"]["digests"] == [3008062094]


def test_pin_quorum():
    want = chip_smoke.quorum_view(jax_quorum_chaos_run(**chip_smoke.QUORUM))
    assert want == chip_smoke.PIN_QUORUM
    assert chip_smoke.quorum_view(quorum_chaos_run(**chip_smoke.QUORUM)) == chip_smoke.PIN_QUORUM


@pytest.mark.slow
def test_pin_dgro_1m():
    assert _dgro_pass(jp.dgro_place, chip_smoke.DGRO_1M) == chip_smoke.PIN_DGRO_1M["pass"]


@pytest.mark.slow
def test_pin_gameday():
    from ringpop_tpu.obs.gameday import bare_digests, gameday_pair

    for scenario in chip_smoke.GAMEDAY_SCENARIOS:
        pair = gameday_pair(scenario=scenario, **chip_smoke.GAMEDAY)
        head = bare_digests(scenario=scenario, **chip_smoke.GAMEDAY)
        assert chip_smoke.gameday_view(pair, head) == chip_smoke.PIN_GAMEDAY[scenario]


def test_pin_views_are_whole():
    """Every pin the script reads is filled, and the game day's pins hold
    simbench's certificate for the zone cut."""
    assert chip_smoke.PIN_DGRO_1M["pass"]["family"] == 12 and chip_smoke.PIN_DGRO_1M["pass"]["probes"] == 1 << 15
    assert set(chip_smoke.PIN_FANIN) == {r[0] for r in chip_smoke.FANIN_RUNS}
    zc = chip_smoke.PIN_GAMEDAY["zone_cut"]
    assert zc["mitigated_earlier"] and zc["chain_ok"] and not zc["stray_rules"] and zc["twin_actions"] == 0
    assert zc["digests_on"] == zc["digests_off"] == zc["digests_bare"]
    assert set(chip_smoke.PIN_GAMEDAY) == set(chip_smoke.GAMEDAY_SCENARIOS)
    assert np.all([len(d) == 2 for d in (zc["digests_on"], zc["digests_bare"])])
