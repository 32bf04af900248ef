"""The simbench twin's mesh and multi-host rows against the JAX package's,
on the CPU, seed 0: ``sharded100k`` (the lifecycle engine over a 4 x 2
mesh: the JAX package's 8 virtual CPU devices, the port's 8 rank
processes), and ``multihost16m``, ``dcn_wire`` and ``swing_overlap`` (the
delta engine over 1, 2 and 4 rank processes through the fabric).

Each whole row takes minutes in one package or the other on the CPU (the
JAX rows 1–5 min and more, the port's 60–160 s), so the whole-row
comparisons are ``slow``.  There every field is held equal but walls,
rates, peak RSS, the warm start's cache state and path, the description
of the mesh's devices or the exchange path, the fabric legs' blocked and
hidden milliseconds, and each ``certified`` that folds in a wall ratio
(``dcn_wire``, ``swing_overlap``); the lists below name them.

Tier-1 runs each row's recipe at a smaller n through both packages'
public functions:

- ``sharded100k`` at 4096 x 256 (100 victims, 6 ticks, the detect path in
  blocks of 32): in the JAX package unsharded and over its 4 x 2 mesh of
  virtual devices, in the port unsharded and over 8 rank processes; the
  certificates hold, and the unsharded states' digests are equal across
  the packages; the ``step1m`` leg at 8192 x 256 through the warm start;
- the fabric rows' legs at 4096 x 64 (``_MH_TWIN``'s victims and loss):
  the twin at P = 1, 2 (codec on and off, swing with overlap) and 4, each
  digest equal to the JAX engine's ``delta.step`` run; the P = 2 save
  restored at P = 4 equal to the JAX engine's unbroken run; the
  convergence at P = 1 and 2 equal to each other.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.cli import simbench as jsb
from ringpop_tpu.sim import delta as jdelta, lifecycle as jlifecycle, telemetry as jtelemetry
from ringpop_tpu_torch.cli import simbench as tsb
from torch_simbench_compare import assert_rows_match

SEED = 0
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _one_thread_a_rank(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the rank processes inherit it
    monkeypatch.setenv("RINGPOP_TPU_AOT_CACHE", str(tmp_path))


def jax_sharded_recipe(n: int, k: int, ticks: int, seed: int) -> dict:
    """The JAX row's child script at ``n`` x ``k``, in this process's 8
    virtual CPU devices."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ringpop_tpu.parallel.mesh import with_exchange_mesh
    from ringpop_tpu.sim.delta import DeltaFaults

    rng = np.random.default_rng(seed)
    victims = np.sort(rng.choice(n, size=100, replace=False))
    up = np.ones(n, bool)
    up[victims] = False
    faults = DeltaFaults(up=jnp.asarray(up))
    params = jlifecycle.LifecycleParams(n=n, k=k, suspect_ticks=10, rng="counter")
    blk = jax.jit(functools.partial(jlifecycle._run_block, params), static_argnames="ticks")
    ref = blk(jlifecycle.init_state(params, seed=seed), faults, ticks=ticks)
    mesh = Mesh(np.asarray(jax.devices("cpu")[:8]).reshape(4, 2), ("node", "rumor"))
    sm_params = with_exchange_mesh(params, mesh)
    sm_blk = jax.jit(functools.partial(jlifecycle._run_block, sm_params), static_argnames="ticks")
    shardings = jlifecycle.state_shardings(mesh, k=k)
    sout = sm_blk(jax.tree.map(jax.device_put, jlifecycle.init_state(params, seed=seed), shardings), faults,
                  ticks=ticks)
    equal = all(bool((np.asarray(a) == np.asarray(b)).all()) for a, b in zip(jax.tree.leaves(ref),
                                                                                jax.tree.leaves(sout)))
    subjects = jnp.asarray(victims, jnp.int32)
    kw = dict(min_status=jlifecycle.FAULTY, block_ticks=32, max_blocks=jnp.int32(16))
    dref, rb, rd = jlifecycle._run_until_detected_device(params, jlifecycle.init_state(params, seed=seed), faults,
                                                         subjects, **kw)
    dsh, sb, sd = jlifecycle._run_until_detected_device(
        sm_params, jax.tree.map(jax.device_put, jlifecycle.init_state(params, seed=seed), shardings), faults,
        subjects, learned_sharding=NamedSharding(mesh, P("node", None)), **kw)
    detect_equal = all(bool((np.asarray(a) == np.asarray(b)).all()) for a, b in zip(jax.tree.leaves(dref),
                                                                                       jax.tree.leaves(dsh)))
    return {"tick_equal": equal, "detected": bool(rd), "ticks": int(rb) * 32, "blocks_equal": int(rb) == int(sb),
            "verdict_equal": bool(rd) == bool(sd), "state_equal": detect_equal,
            "digests": {"tick": int(jtelemetry.tree_digest(ref)), "detect": int(jtelemetry.tree_digest(dref))}}


def test_sharded100k_recipe_at_4096():
    want = jax_sharded_recipe(4096, 256, 6, SEED)
    got = tsb.sharded_certificate(4096, 256, 6, SEED, CPU, step1m={"n": 8192, "k": 256})
    detect = got["detect"]
    assert want["tick_equal"] and want["blocks_equal"] and want["verdict_equal"] and want["state_equal"]
    assert got["tick_equal"] and detect["blocks_equal"] and detect["verdict_equal"] and detect["state_equal"]
    assert (detect["detected"], detect["ticks"]) == (want["detected"], want["ticks"]) and want["detected"]
    assert got["digests"] == want["digests"]
    assert got["n_devices"] == 8 and got["transport"] == "gloo"
    step = got["step1m"]
    assert step["ok"] and step["tick"] == 1 and step["cache_hit"] is False and step["aot_error"] is None, step


def jax_delta_digest(n: int, k: int, ticks: int, victims: int, drop, seed: int) -> int:
    params = jdelta.DeltaParams(n=n, k=k, rng="counter")
    rng = np.random.default_rng(seed + 999)
    up = np.ones(n, bool)
    up[rng.choice(n, size=victims, replace=False)] = False
    kw = {} if drop is None else {"drop_rate": jnp.float32(drop)}
    faults = jdelta.DeltaFaults(up=jnp.asarray(up), **kw)
    st = jdelta.init_state(params, seed=seed)
    stp = jax.jit(functools.partial(jdelta.step, params))
    for _ in range(ticks):
        st = stp(st, faults)
    return int(jtelemetry.tree_digest(st))


def test_fabric_rows_recipe_at_4096(tmp_path):
    n, k, ticks, victims, drop = 4096, 64, 24, 64, 0.05
    anchor = jax_delta_digest(n, k, ticks, victims, drop, SEED)
    assert tsb._delta_twin_digest(n, k, ticks, victims, drop, SEED, CPU) == anchor
    launch, base = tsb._mh_launch()
    common = ["--n", str(n), "--k", str(k), "--seed", str(SEED), "--victims", str(victims), "--drop", str(drop),
              "--ticks", str(ticks)]
    for nprocs, extra in ((1, []), (2, []), (2, ["--codec", "off"]), (2, ["--schedule", "swing", "--overlap", "on"]),
                          (4, [])):
        ranks = launch(nprocs, base + ["twin", *common, *extra], timeout_s=300, device="cpu")
        assert {r["records"][-1]["digest"] for r in ranks} == {anchor}, (nprocs, extra)
    ckpt = str(tmp_path / "ck")
    snap = ["--n", str(n), "--k", str(k), "--seed", str(SEED), "--victims", str(victims)]
    saved = launch(2, base + ["snapshot-save", *snap, "--ticks", "8", "--path", ckpt], timeout_s=300, device="cpu")
    rest = launch(4, base + ["snapshot-restore", *snap, "--extra-ticks", "4", "--path", ckpt], timeout_s=300,
                  device="cpu")
    unbroken = jax_delta_digest(n, k, 12, victims, None, SEED)
    assert tsb._delta_twin_digest(n, k, 12, victims, None, SEED, CPU) == unbroken
    assert rest[0]["records"][-1]["digest_at_restore"] == saved[0]["records"][-1]["digest"]
    assert {r["records"][-1]["digest"] for r in rest} == {unbroken}
    conv = ["converge", "--n", str(n), "--k", str(k), "--seed", str(SEED), "--max-ticks", "4096"]
    results = [[next(rec for rec in reversed(r["records"]) if rec["kind"] == "result")
                for r in launch(p, base + conv, timeout_s=300, device="cpu")] for p in (1, 2)]
    assert len({r["digest"] for rs in results for r in rs}) == 1
    assert all(r["converged"] for rs in results for r in rs) and results[0][0]["ticks"] == results[1][0]["ticks"]


SHARDED100K_INEXACT = {
    "value": "host clock", "unsharded_s": "host clock", "detect_sharded_s": "host clock",
    "detect_unsharded_s": "host clock", "detect_sharded_exec_s": "host clock", "detect_unsharded_exec_s": "host clock",
    "mesh": "names the mesh's devices", "step1m.first_call_s": "host clock", "step1m.compile_s": "host clock",
    "step1m.execute_s": "host clock", "step1m.cache_hit": "the warm start's cache state", "step1m.cache_dir": "a path",
}
MULTIHOST_INEXACT = {
    "value": "peak RSS fraction", "twin.*.peak_rss_mb": "peak RSS", "twin.*.wall_s": "host clock",
    "scale.*.wall_s": "host clock", "scale.*.ms_per_tick": "host clock", "scale.*.peak_rss_mb": "peak RSS",
    "exchange_path": "describes the backend",
}
DCN_INEXACT = {
    "certified": "folds in the on/off wall ratio", "scale.*.wall_s": "host clock",
    "scale.*.worker_wall_s": "host clock", "scale.*.ms_per_tick": "host clock", "scale.*.peak_rss_mb": "peak RSS",
    "wall_ratio_on_over_off": "a ratio of walls",
}
SWING_INEXACT = {
    "value": "a ratio of walls", "certified": "folds in wall ratios", "overlap_certified": "folds in a wall ratio",
    "swing_certified": "folds in a wall ratio", "twin.*.leg_ms": "host clock", "twin.*.overlap_hidden_ms": "host clock",
    "overlap_ab.*.walls": "host clock", "overlap_ab.*.wall_min": "host clock", "overlap_ab.*.wall_median": "host clock",
    "overlap_ab.*.leg_ms": "host clock", "overlap_ab.*.overlap_hidden_ms": "host clock",
    "overlap_ab.wall_ratio_min": "a ratio of walls", "overlap_ab.wall_ratio_median": "a ratio of walls",
    "swing_ab.*.walls": "host clock", "swing_ab.*.wall_min": "host clock", "swing_ab.*.leg_ms": "host clock",
    "swing_ab.wall_ratio_min": "a ratio of walls",
}


@pytest.mark.slow
@pytest.mark.parametrize("row,inexact", [("sharded100k", SHARDED100K_INEXACT), ("multihost16m", MULTIHOST_INEXACT),
                                         ("dcn_wire", DCN_INEXACT), ("swing_overlap", SWING_INEXACT)])
def test_mesh_row(row, inexact):
    want = jsb.BENCHES[row](SEED, False)
    got = tsb.BENCHES[row](SEED, False, device=CPU)
    assert_rows_match(want, got, inexact)
