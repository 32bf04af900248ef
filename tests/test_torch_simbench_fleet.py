"""The simbench twin's fleet rows against the JAX package's, on the CPU at
simbench's non-full sizes, seed 0: ``montecarlo`` and ``mc_churn`` (512 x
32, 8 replicas), ``mc_chaos`` (the 32-scenario churn x loss surface, its
sequential certificate and its scored journal) and ``fleet_scale`` (the
process-sliced sweep, its checkpoint, the fleet mesh twin and the adaptive
cliff search).

Every field of the two records is held equal but these:

- ``mc_chaos``: ``value``, ``surface_wall_s``, ``throughput``'s walls,
  speed-ups and rates, ``scored.wall_s`` (host clock); ``compile_s``,
  ``cache_hit`` and ``cache_dir`` (the warm start's cache: its state and
  its path);
- ``fleet_scale``: ``value``, ``rss_*`` (the processes' peak RSS),
  ``certified`` (it folds in the RSS fraction; every other part of it is
  held), ``p1_wall_s``, ``p2_wall_s``, ``save_s``, the adaptive search's
  walls, ``compile_s`` and ``cache_hit``, ``restored_from.checkpoint`` (a
  temporary path) and ``twin.mesh`` (names the twin's devices).

``mc_chaos`` takes ~230 s in the port on one thread and ``fleet_scale``
~225 s, so their whole-row comparisons are ``slow``.  Tier-1 runs their
recipes at a smaller n through both packages' public functions: the
surface, the sequential pass and the scored fleet at 256 x 32 over 8
scenarios; the fleet twin at 128 x 16 and the adaptive search against the
dense one at 128 x 16 to dose 8.  The sweep legs are held in tier-1 by
``tests/test_torch_fleet_bench.py``.
"""

import numpy as np
import pytest
import torch

from ringpop_tpu.cli import simbench as jsb
from ringpop_tpu.sim import lifecycle as jlifecycle, scenarios as jscenarios
from ringpop_tpu_torch.cli import simbench as tsb
from ringpop_tpu_torch.sim import lifecycle as tlifecycle, scenarios as tscenarios
from torch_simbench_compare import assert_rows_match

SEED = 0
CPU = torch.device("cpu")

MC_CHAOS_INEXACT = {
    "value": "a ratio of walls", "surface_wall_s": "host clock", "scored.wall_s": "host clock",
    "throughput.batched_s": "host clock", "throughput.sequential_s": "host clock",
    "throughput.sequential_warm_s": "host clock", "throughput.speedup": "a ratio of walls",
    "throughput.speedup_vs_warm": "a ratio of walls", "throughput.batched_rtn_per_s": "a rate",
    "throughput.sequential_rtn_per_s": "a rate", "compile_s": "the warm start's cache state",
    "cache_hit": "the warm start's cache state", "cache_dir": "a path",
}
FLEET_SCALE_INEXACT = {
    "value": "peak RSS fraction", "rss_p1_mb": "peak RSS", "rss_p2_max_mb": "peak RSS", "rss_frac": "peak RSS",
    "certified": "folds in the peak RSS fraction", "p1_wall_s": "host clock", "p2_wall_s": "host clock",
    "save_s": "host clock", "restored_from.checkpoint": "a temporary path", "twin.mesh": "names the twin's devices",
    "adaptive.adaptive_wall_s": "host clock", "adaptive.dense_wall_s": "host clock",
    "adaptive.compile_s": "the warm start's cache state", "adaptive.cache_hit": "the warm start's cache state",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _aot_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("RINGPOP_TPU_AOT_CACHE", str(tmp_path))


@pytest.mark.parametrize("row", ["montecarlo", "mc_churn"])
def test_replica_row(row):
    want = jsb.BENCHES[row](SEED, False)
    got = tsb.BENCHES[row](SEED, False, device=CPU)
    assert_rows_match(want, got, {})


def mc_chaos_recipe(scenarios, lifecycle, n: int, b_doses: int, horizon: int, **kw):
    rng = np.random.default_rng(SEED)
    victims = sorted(rng.choice(n, size=4, replace=False).tolist())
    doses = scenarios.mc_churn_doses(b_doses, n // 32)
    params = lifecycle.LifecycleParams(n=n, k=32)
    plan, meta = scenarios.scenario_grid(n, victims=victims, doses=doses, losses=(0.0, 0.1), churn_seed=SEED + 777,
                                         **kw)
    seeds = scenarios.grid_seeds(meta, SEED)
    ticks, detected, _ = scenarios.detect_surface(params, plan, seeds, victims, max_ticks=4096, **kw)
    # fresh_compile False: the JAX pass then compiles one program, not one a scenario
    seq_t, seq_d = scenarios.sequential_detect(params, plan, seeds, victims, max_ticks=4096, fresh_compile=False,
                                               **kw)
    scores = scenarios.scored_fleet(params, plan, meta, seeds, horizon=horizon, journal_every=16, **kw)
    surface = scenarios.response_surface(meta, [int(t) if d else None for t, d in zip(ticks, detected)],
                                         rows="loss", cols="churn")
    return {"ticks": [int(t) for t in ticks], "detected": [bool(d) for d in detected],
            "sequential": [[int(t) for t in seq_t], [bool(d) for d in seq_d]], "surface": surface, "scores": scores}


def test_mc_chaos_recipe_at_256():
    want = mc_chaos_recipe(jscenarios, jlifecycle, 256, 4, 32)
    got = mc_chaos_recipe(tscenarios, tlifecycle, 256, 4, 32, device=CPU)
    assert_rows_match(want, got, {})
    assert got["ticks"] == got["sequential"][0] and all(got["detected"])


def test_fleet_scale_twin_and_cliff_search_at_128():
    want = jsb._fleet_sharded_twin(SEED, n=128, k=16, ticks=8)
    got = tsb._fleet_sharded_twin(SEED, n=128, k=16, ticks=8, device=CPU)
    assert_rows_match(want, got, {"mesh": "names the twin's devices"})
    assert got["equal"] is True
    rng = np.random.default_rng(SEED)
    kw = dict(victims=sorted(rng.choice(128, size=4, replace=False).tolist()), losses=(0.0,), max_dose=8,
              churn_seed=SEED + 777, max_ticks=4096, check_every=1, seeds_per_point=1)
    for fn in ("refine_surface", "dense_surface"):
        extra = {"coarse": 3} if fn == "refine_surface" else {}
        want = getattr(jscenarios, fn)(jlifecycle.LifecycleParams(n=128, k=16), **extra, **kw)
        got = getattr(tscenarios, fn)(tlifecycle.LifecycleParams(n=128, k=16), device=CPU, **extra, **kw)
        assert got == want, fn


@pytest.mark.slow
def test_mc_chaos():
    want = jsb.bench_mc_chaos(SEED, False)
    got = tsb.bench_mc_chaos(SEED, False, device=CPU)
    assert_rows_match(want, got, MC_CHAOS_INEXACT)
    assert got["throughput"]["ticks_equal"] is True


@pytest.mark.slow
def test_fleet_scale(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the rank processes inherit it
    want = jsb.bench_fleet_scale(SEED, False)
    got = tsb.bench_fleet_scale(SEED, False, device=CPU)
    assert_rows_match(want, got, FLEET_SCALE_INEXACT)
    assert got["digests_equal"] and got["scores_equal"] and got["restore_exact"] and got["twin"]["equal"]
