"""The delta engine sharded over node ranks (``parallel/mesh``,
``parallel/partition``), against the JAX package, bit for bit.

One spawned group of P gloo ranks on the CPU (P = 1, 2 and 4) runs every
case of the module (``tests/torch_dist_worker.py``); the JAX side runs
here, unsharded and sharded on a (P, 1) virtual mesh with the shard-local
exchange legs (``with_exchange_mesh``).  Each run is 24 ticks at n 256-512,
k 64: the shift exchange with nodes down and 1 % loss at the counter
stream, the same at threefry, the uniform exchange (its planes gathered),
and a ``chaos.scenario_plan``.  Every leaf gathered from the ranks
(``partition.host_gather``) must equal both JAX runs; ``converged`` and the
combined digest (``tree_digest`` over a mesh: per-rank partial sums) must
equal JAX's exactly, and ``converged_fraction`` the unsharded port's (its
float32 sum order is the port's, 1e-6 from JAX's, as
``tests/test_torch_delta.py`` holds it).  At one rank the mesh is a no-op
(``with_exchange_mesh``), so the JAX sharded program there is the
unsharded one.  The lifecycle engine's runs are in
``tests/test_torch_sharded_lifecycle.py``; the helpers here serve both.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from ringpop_tpu.parallel.mesh import shard_delta_state, with_exchange_mesh as jwith_exchange_mesh
from ringpop_tpu.sim import chaos as jchaos, delta as jd, lifecycle as jl, telemetry as jt
from ringpop_tpu.sim.delta import DeltaFaults as JFaults

from ringpop_tpu_torch.parallel import multihost, partition
from ringpop_tpu_torch.parallel.mesh import Mesh, delta_shardings, with_exchange_mesh
from ringpop_tpu_torch.sim import delta as td, lifecycle as tl, montecarlo, snapshot

from torch_dist_worker import run_group

RANKS = (1, 2, 4)
DOWN = [3, 40, 77, 130, 201, 255]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def spec(engine, n, rng="counter", exchange="shift", plan=None, **kw):
    out = {"engine": engine, "n": n, "k": 64, "rng": rng, "exchange": exchange, "seed": 5, "ticks": 24,
           "down": DOWN, "drop": 0.01, "plan": plan, "suspect_ticks": 5, "heal_prob": 0.3}
    out.update(kw)
    return out


DELTA_RUNS = {
    "counter": spec("delta", 512, loop=True),
    "threefry": spec("delta", 512, rng="threefry"),
    "uniform": spec("delta", 256, exchange="uniform"),
    "sequential_h4": spec("delta", 512, h=4, pipelined=False),
    "chaos": spec("delta", 512, plan="smoke"),
}


# -- the JAX side --------------------------------------------------------------


def jax_faults(s):
    if s["plan"]:
        return jchaos.scenario_plan(s["plan"], s["n"], seed=s["seed"], horizon=s["ticks"])
    up = np.ones(s["n"], bool)
    up[s["down"]] = False
    return JFaults(up=jnp.asarray(up), drop_rate=jnp.float32(s["drop"]))


def jax_params(s):
    if s["engine"] == "delta":
        return jd.DeltaParams(n=s["n"], k=s["k"], rng=s["rng"], exchange=s["exchange"])
    return jl.LifecycleParams(n=s["n"], k=s["k"], rng=s["rng"], exchange=s["exchange"],
                              suspect_ticks=s["suspect_ticks"], heal_prob=s["heal_prob"])


@functools.lru_cache(maxsize=None)
def jax_mesh(p):
    return JMesh(np.asarray(jax.devices("cpu")[:p]).reshape(p, 1), ("node", "rumor"))


def jax_run(s, p=None):
    """The JAX package's run of ``s``: unsharded (``p`` None), or sharded
    on a (p, 1) mesh with the shard-local legs.  Returns the final state."""
    params = jax_params(s)
    faults = jax_faults(s)
    engine = jd if s["engine"] == "delta" else jl
    state = engine.init_state(params, seed=s["seed"])
    if p is not None:
        mesh = jax_mesh(p)
        params = jwith_exchange_mesh(params, mesh, h=s.get("h"), pipelined=s.get("pipelined"))
        state = (shard_delta_state(state, mesh) if s["engine"] == "delta"
                 else jax.tree.map(jax.device_put, state, jl.state_shardings(mesh, k=s["k"])))
    if s["engine"] == "delta":
        fn = jax.jit(functools.partial(jd.step, params))
        for _ in range(s["ticks"]):
            state = fn(state, faults)
        return state
    return jax.jit(functools.partial(jl._run_block, params), static_argnames="ticks")(state, faults, ticks=s["ticks"])


_jax_cache: dict = {}


def jax_state(name, s, p=None):
    key = (name, p)
    if key not in _jax_cache:
        _jax_cache[key] = jax_run(s, p)
    return _jax_cache[key]


def assert_leaves(got, want, fields, dtypes, what):
    """Port leaves gathered from the ranks (numpy of the port's dtypes)
    against JAX leaves, through the JAX dtypes (uint32 planes are int32
    bits in the port, the key int64)."""
    for name, g, w in zip(fields, got, want):
        np_dtype = dtypes[name][0]
        g = np.asarray(g)
        g = g.view(np_dtype) if g.dtype.itemsize == np.dtype(np_dtype).itemsize else g.astype(np_dtype)
        assert np.array_equal(g, np.asarray(w)), f"{what}: leaf {name}"


def port_faults(s):
    """The port's faults for ``s`` on the CPU (unsharded comparisons)."""
    from ringpop_tpu_torch.sim import chaos

    if s["plan"]:
        return chaos.scenario_plan(s["plan"], s["n"], seed=s["seed"], horizon=s["ticks"], device="cpu")
    up = np.ones(s["n"], bool)
    up[s["down"]] = False
    return td.DeltaFaults(up=torch.as_tensor(up), drop_rate=torch.tensor(s["drop"], dtype=torch.float32))


# -- the port's groups -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def group(p):
    jobs = [(name, "engine_run", s) for name, s in DELTA_RUNS.items()]
    jobs.append(("sim", "sim_run", spec("delta", 512)))
    if p > 1:
        jobs.append(("refusals", "refusals", {}))
    return run_group(p, jobs)


CASES = [(name, p) for name in DELTA_RUNS for p in RANKS]


@pytest.mark.parametrize("name,p", CASES)
def test_leaves_equal_jax_unsharded(name, p):
    s = DELTA_RUNS[name]
    assert_leaves(group(p)[name]["leaves"], jax_state(name, s), td.DeltaState._fields, td._LEAF_DTYPES,
                  f"{name} over {p} ranks vs JAX unsharded")


@pytest.mark.parametrize("name,p", [(name, p) for name, p in CASES if p > 1])
def test_leaves_equal_jax_sharded(name, p):
    s = DELTA_RUNS[name]
    assert_leaves(group(p)[name]["leaves"], jax_state(name, s, p), td.DeltaState._fields, td._LEAF_DTYPES,
                  f"{name} over {p} ranks vs JAX on a ({p}, 1) mesh")


@pytest.mark.parametrize("name,p", CASES)
def test_queries_and_digest_span_the_ranks(name, p):
    """``converged`` and the digest exactly as JAX's; ``converged_fraction``
    bit-equal to the unsharded port's (every rank's per-row counts are
    gathered and summed whole) and 1e-6 from JAX's."""
    s = DELTA_RUNS[name]
    got = group(p)[name]
    js = jax_state(name, s)
    jf = jax_faults(s)
    assert got["converged"] == bool(jd.converged(js, jf))
    assert got["digest"] == int(jt.tree_digest(js))
    whole = td.state_from_numpy(js, device="cpu")
    assert got["fraction"] == float(td.converged_fraction(whole, port_faults(s)))
    assert got["fraction"] == pytest.approx(float(jd.converged_fraction(js, jf)), rel=1e-6)


@pytest.mark.parametrize("p", RANKS)
def test_run_until_converged_spans_the_ranks(p):
    s = DELTA_RUNS["counter"]
    ticks, done, leaves = group(p)["counter"]["run"]
    js, jticks, jdone = jd.run_until_converged(jax_params(s), jax_state("counter", s), jax_faults(s),
                                               max_ticks=64, check_every=8)
    assert (ticks, done) == (jticks, jdone)
    assert_leaves(leaves, js, td.DeltaState._fields, td._LEAF_DTYPES, f"run_until_converged over {p} ranks")


@pytest.mark.parametrize("p", RANKS)
def test_delta_sim_journal_over_a_mesh(p):
    """``DeltaSim(exchange_mesh=...)``: the journal's coverage and digest
    records and the final state equal the unsharded port's."""
    s = spec("delta", 512)
    got = group(p)["sim"]
    records = []
    sim = td.DeltaSim(512, 64, seed=s["seed"], rng="counter", telemetry_sink=records.append, device="cpu")
    assert got["result"] == sim.run_until_converged(port_faults(s), max_ticks=64, journal_every=16)
    assert got["records"] == [{k: (v.item() if isinstance(v, torch.Tensor) else v) for k, v in r.items()}
                              for r in records]
    for name, g in zip(td.DeltaState._fields, got["leaves"]):
        assert np.array_equal(g, getattr(sim.state, name).numpy()), name


def test_partition_tables_and_shardings():
    mesh = Mesh(size=2, rank=1, device=torch.device("cpu"), transport="gloo")
    sh = delta_shardings(mesh)
    assert isinstance(sh, td.DeltaState)
    assert sh.learned == partition.NamedSharding(mesh, partition.P("node", "rumor"))
    assert sh.tick.spec == partition.P() and sh.key.spec == partition.P()
    life = tl.state_shardings(mesh, k=64)
    assert life.base_status.spec == partition.P("node") and life.r_subject.spec == partition.P("rumor")
    assert mesh.shape == {"node": 2, "rumor": 1} and mesh.coords == {"node": 1, "rumor": 0}
    # with_exchange_mesh: a no-op at one node rank and when a mesh is bound;
    # overrides apply either way, the mesh is never rebound
    params = td.DeltaParams(n=64, k=32)
    one = Mesh(size=1, rank=0, device=torch.device("cpu"), transport="gloo")
    assert with_exchange_mesh(params, one) is params
    bound = with_exchange_mesh(params, mesh, h=4)
    assert bound.exchange_mesh is mesh and bound.exchange_h == 4
    other = Mesh(size=2, rank=0, device=torch.device("cpu"), transport="gloo")
    rebound = with_exchange_mesh(bound, other, pipelined=False)
    assert rebound.exchange_mesh is mesh and not rebound.exchange_pipelined and rebound.exchange_h == 4
    # this rank's block of a whole state, and its rows at their global index
    whole = td.init_state(td.DeltaParams(n=64, k=32, rng="counter"), seed=1, device="cpu")
    block = partition.shard_put(whole, mesh, 64)
    assert torch.equal(block.learned, whole.learned[32:]) and torch.equal(block.key, whole.key)
    assert partition.shard_put(block, mesh, 64).learned.shape == (32, 1)
    with pytest.raises(ValueError, match="neither"):
        partition.shard_put(whole._replace(learned=whole.learned[:10]), mesh, 64)


def test_a12b_refusals_and_divisibility(tmp_path):
    """A12b is ported: telemetry under a mesh builds the rank's block of
    accumulators, a rumor axis places word blocks, and the fleet's routes
    that were refused here now work at a small size — the one-rank fleet
    mesh, the batch-axis placement and gather (a mesh without a batch axis
    is refused with the JAX package's ValueError), the store behind the
    orbax checkpoints.  Ranks that do not divide n raise ValueError as
    ``process_block`` does, and so does a ``rumor_shards`` that does not
    divide the job."""
    mesh = Mesh(size=2, rank=0, device=torch.device("cpu"), transport="gloo")
    life = tl.LifecycleParams(n=64, k=32, rng="counter", exchange_mesh=mesh)
    sim = tl.LifecycleSim(64, k=32, rng="counter", telemetry=True, exchange_mesh=mesh)
    assert sim.telemetry.pings.shape == (32,) and sim.telemetry.piggybacked.shape == (32, 1)
    block = tl.init_state(life, device="cpu")
    assert block.learned.shape == (32, 1) and block.r_subject.shape == (32,)
    assert montecarlo.make_fleet_mesh(device="cpu").shape == {"batch": 1, "node": 1, "rumor": 1}
    with pytest.raises(ValueError, match="'batch' axis"):
        partition.fleet_shard_put({}, mesh, 4)
    placed = partition.fleet_shard_put({"a": torch.arange(4)}, montecarlo.fleet_save_mesh(device="cpu"), 4)
    assert placed["a"].offset == (0,) and placed["a"].shape == (4,)
    assert partition.fleet_host_gather(placed)["a"].tolist() == [0, 1, 2, 3]
    snapshot.save_state_orbax(str(tmp_path / "block"), block)
    assert torch.equal(snapshot.load_state_orbax(str(tmp_path / "block"), block).learned, block.learned)
    with pytest.raises(ValueError, match="must divide"):
        multihost.make_multihost_mesh(rumor_shards=3)
    whole = tl.init_state(tl.LifecycleParams(n=64, k=64, rng="counter"), seed=2, device="cpu")
    placed = partition.shard_put(whole, _RumorMesh(), 64)
    assert torch.equal(placed.learned, whole.learned[:32, 1:]) and torch.equal(placed.pcount, whole.pcount[:32, 32:])
    assert torch.equal(placed.r_subject, whole.r_subject) and torch.equal(placed.base_inc, whole.base_inc[:32])
    assert partition.block_of(partition.P("node", "rumor"), _RumorMesh(), (64, 2)) == ((0, 1), (32, 1), True)
    for bad in (td.DeltaParams(n=63, k=32, exchange_mesh=mesh), tl.LifecycleParams(n=63, k=32, exchange_mesh=mesh)):
        engine = td if isinstance(bad, td.DeltaParams) else tl
        with pytest.raises(ValueError, match="must divide"):
            engine.init_state(bad, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        partition.process_block(63, 0, 2)


class _RumorMesh(Mesh):
    """The (2, 2) mesh's rank at (0, 1), without a process group: enough
    for placement, which needs no collective."""

    def __init__(self):
        super().__init__(size=2, rank=0, device=torch.device("cpu"), transport="gloo", rumor_size=2, rumor_rank=1)


@pytest.mark.parametrize("p", [2, 4])
def test_rumor_axis_refused_in_a_live_group(p):
    """A rumor axis of 2 in a live group of p ranks, refused before the
    rumor axis was ported, now builds: ``make_mesh(shape=(p/2, 2))`` and
    ``make_multihost_mesh(rumor_shards=2)`` give rank 0 at (0, 0) of a
    (p/2, 2) mesh."""
    got = group(p)["refusals"]
    want = ({"node": p // 2, "rumor": 2}, {"node": 0, "rumor": 0})
    assert got["make_mesh"] == want and got["make_multihost_mesh"] == want, got
