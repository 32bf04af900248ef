"""The simbench twin's ``topo_chaos`` row against the JAX package's, on the
CPU, seed 0.

The whole row at its non-full size (512 x 32, 18 stacked topology plans
through the scored fleet for 256 ticks, and the topology smoke plan's
sharded twin) takes ~45 s in each package, so its comparison is ``slow``.
Every field is held equal there but ``value`` (the fleet's wall, host
clock) and ``sharded_twin.mesh`` (the description of the twin's devices).
The twin's digests are held in tier-1 by
``tests/test_torch_simbench_chaos.py`` (``chip_smoke.PIN_CHAOS_TWIN``).

Tier-1 runs the row's recipe at 256 x 32 with a 64-tick horizon through
both packages' public functions (``topology.default_topology``,
``topo_scenario_specs``, ``chaos.stack_plans``, ``scenarios.scored_fleet``)
and holds every score record equal.
"""

import pytest
import torch

from ringpop_tpu.cli import simbench as jsb
from ringpop_tpu.sim import chaos as jchaos, lifecycle as jlifecycle, scenarios as jscenarios
from ringpop_tpu.sim import topology as jtopology
from ringpop_tpu_torch.cli import simbench as tsb
from ringpop_tpu_torch.sim import chaos as tchaos, lifecycle as tlifecycle, scenarios as tscenarios
from ringpop_tpu_torch.sim import topology as ttopology
from torch_simbench_compare import assert_rows_match

SEED = 0
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def topo_recipe(pkg, n: int, horizon: int):
    chaos, lifecycle, scenarios, topology = pkg
    topo = topology.default_topology(n)
    kw = {} if pkg[0] is jchaos else {"device": CPU}
    plans, meta = topology.topo_scenario_specs(topo, seed=SEED, horizon=horizon, reps=1, **kw)
    stacked = chaos.stack_plans(plans)
    params = lifecycle.LifecycleParams(n=n, k=32, suspect_ticks=10, rng="counter")
    seeds = [SEED + i for i in range(len(plans))]
    scores = scenarios.scored_fleet(params, stacked, meta, seeds, horizon=horizon, journal_every=16,
                                    scenario="topo_chaos", **kw)
    return {"b": chaos.plan_batch_size(stacked), "meta": meta, "scores": scores,
            "tier_drop": [float(x) for x in topo.tier_drop]}


def test_topo_chaos_recipe_at_256():
    want = topo_recipe((jchaos, jlifecycle, jscenarios, jtopology), 256, 64)
    got = topo_recipe((tchaos, tlifecycle, tscenarios, ttopology), 256, 64)
    assert_rows_match(want, got, {})
    assert all(isinstance(s.get("suspects_by_tier"), dict) for s in got["scores"])


@pytest.mark.slow
def test_topo_chaos():
    want = jsb.bench_topo_chaos(SEED, False)
    got = tsb.bench_topo_chaos(SEED, False, device=CPU)
    assert_rows_match(want, got, {"value": "the fleet's wall, host clock",
                                  "sharded_twin.mesh": "names the twin's devices"})
    assert got["certified"] is True
