"""The lifecycle engine: PyTorch port against the JAX package, every leaf at
every tick.

Every leaf of the port's ``LifecycleState`` equals
``ringpop_tpu.sim.lifecycle``'s at every tick, at ``rng="counter"``, on the
CPU, bit for bit: both exchanges, K = 32, 40 and 64, crashes with
``up``, ``drop_rate``, ``drop_node``, ``group``/``reach`` partitions with
the healer firing, the topology tier legs, the ``suspect_ticks`` override
leg and a saturating ``max_p``, with the queries (``believed_key``/
``believed_status``, ``detection_fraction`` on both paths,
``detection_complete``, ``view_checksums``, ``checksums_converged``) at the
end; at ``rng="threefry"``, the default (``tests/test_torch_golden.py``
holds the small configurations to the frozen goldens), both exchanges with
drops, a partition with the healer firing and ``heal_prob`` 0.  The entry
points and run loops are in ``tests/test_torch_lifecycle_runs.py``, the
primitives and hazards in ``tests/test_torch_lifecycle_primitives.py``;
this module's helpers serve all three.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim.delta import DeltaFaults as JFaults

from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.swim.member import FAULTY, SUSPECT

FIELDS = jl.LifecycleState._fields


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's CPU path here runs small tensors: more intra-op threads
    than one only contend with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# one compiled program per shape (an eager call retraces its slot loop)
_j_detection_complete = jax.jit(jl.detection_complete, static_argnums=(3,))


def assert_same_state(js, ts, where=""):
    tn = tl.state_to_numpy(ts)
    for name, a, b in zip(FIELDS, js, tn):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, name, a.dtype, b.dtype)
        assert np.array_equal(a, b), (where, name)


def _victims(n, count, seed=0):
    """bench.py's victim choice (bench.py:435-440)."""
    return np.sort(np.random.default_rng(seed).choice(n, size=count, replace=False))


def _faults(kind, n, down, seed):
    """(JAX DeltaFaults, port DeltaFaults) for a named fault mix with the
    nodes ``down`` crashed."""
    rng = np.random.default_rng(seed)
    legs = {}
    up = np.ones(n, bool)
    up[np.asarray(down, np.int64)] = False
    legs["up"] = up
    if "drop" in kind:
        legs["drop_rate"] = np.float32(0.05)
    if "node" in kind:
        legs["drop_node"] = (rng.random(n) * 0.2).astype(np.float32)
    if "group" in kind:
        legs["group"] = (np.arange(n) * 3 // n - (np.arange(n) % 97 == 0)).astype(np.int32)
    if "reach" in kind:
        reach = rng.random((3, 3)) < 0.5
        np.fill_diagonal(reach, True)
        legs["reach"] = reach
    if "tier" in kind:
        legs["tier_ids"] = np.stack([np.arange(n) // 16, np.arange(n) // 256,
                                     np.arange(n) // 1024]).astype(np.int32)
        legs["tier_drop"] = np.array([0.0, 0.02, 0.1, 0.3], np.float32)
    if "susp" in kind:
        legs["suspect_ticks"] = np.int32(3)
    if "default" in kind:
        legs["suspect_ticks"] = np.int32(-1)  # -1 = use the param
    jf = JFaults(**{k: jnp.asarray(v) for k, v in legs.items()})
    return jf, tl.faults_from_numpy(jf, device="cpu")


def _pair(n, k, exchange="shift", **kw):
    return (jl.LifecycleParams(n=n, k=k, exchange=exchange, rng="counter", **kw),
            tl.LifecycleParams(n=n, k=k, exchange=exchange, rng="counter", **kw))


def _jstep(jp):
    return jax.jit(lambda s, f: jl.step(jp, s, f))


def _run_both(jp, tp, jf, tf, ticks, seed=0, js=None, ts=None, every=None):
    """``ticks`` ticks of both engines from ``seed`` (or the given states),
    every leaf compared at every tick; ``every(t, js, ts)`` is called after
    each tick."""
    if js is None:
        js = jl.init_state(jp, seed=seed)
        ts = tl.init_state(tp, seed=seed, device="cpu")
        assert_same_state(js, ts, "init")
    jstep = _jstep(jp)
    for t in range(ticks):
        js = jstep(js, jf)
        ts = tl.step(tp, ts, tf)
        assert_same_state(js, ts, f"tick {t + 1}")
        if every is not None:
            every(t + 1, js, ts)
    return js, ts


def _assert_same_queries(js, ts, jf, tf, subjects, where=""):
    """Every query of the port equals the JAX package's on one state."""
    subj = np.asarray(subjects, np.int64)
    bk_j, bk_t = np.asarray(jl.believed_key(js, subj)), tl.believed_key(ts, subj)
    assert bk_t.dtype == torch.int32 and np.array_equal(bk_j, bk_t.numpy()), where
    bs_j, bs_t = np.asarray(jl.believed_status(js, subj)), tl.believed_status(ts, subj)
    assert bs_t.dtype == torch.int8 and np.array_equal(bs_j, bs_t.numpy()), where
    for min_status in (SUSPECT, FAULTY):
        fj = np.asarray(jl.detection_fraction(js, subj, jf, min_status))
        ft = tl.detection_fraction(ts, subj, tf, min_status)
        assert ft.dtype == torch.float32 and fj.dtype == np.float32
        assert np.array_equal(fj, ft.numpy()), (where, "fraction", min_status)
        # the large-scale path, called directly (its switch is at 2**28)
        lj = np.asarray(jl._detection_fraction_large(js, subj, jf, min_status))
        lt = tl._detection_fraction_large(ts, subj, tf, min_status)
        assert lt.dtype == torch.float32 and np.array_equal(lj, lt.numpy()), (where, "large", min_status)
        assert bool(_j_detection_complete(js, jnp.asarray(subj, jnp.int32), jf, min_status)) == bool(
            tl.detection_complete(ts, subj, tf, min_status)), (where, "complete", min_status)
    cj = np.asarray(jl.view_checksums(js, jf))
    ct = tl.view_checksums(ts, tf)
    assert ct.dtype == torch.int64 and np.array_equal(cj.astype(np.int64), ct.numpy()), where
    assert bool(jl.checksums_converged(js, jf)) == bool(tl.checksums_converged(ts, tf)), where


# -- every leaf, every tick ----------------------------------------------------

CONFIGS = [
    # (n, k, exchange, faults, victims, ticks, params)
    (4096, 32, "shift", "", 12, 36, {}),
    (2048, 40, "uniform", "", 12, 32, {}),
    (2048, 40, "shift", "drop", 20, 30, {"suspect_ticks": 5}),
    (2048, 64, "uniform", "drop node", 20, 24, {"suspect_ticks": 5}),
    (2048, 40, "shift", "group", 8, 30, {"heal_prob": 0.6, "suspect_ticks": 4}),
    (2048, 32, "uniform", "group reach", 8, 24, {"heal_prob": 0.6, "suspect_ticks": 4}),
    (2048, 64, "shift", "tier node", 16, 24, {"suspect_ticks": 4}),
    (2048, 40, "uniform", "tier drop", 16, 24, {}),
    (2048, 32, "shift", "susp", 16, 24, {}),
    (2048, 32, "shift", "default drop", 16, 30, {"suspect_ticks": 4, "faulty_ticks": 6,
                                                 "tombstone_ticks": 5}),
    (2048, 40, "shift", "drop", 40, 32, {"max_p": 2, "suspect_ticks": 3, "alloc_per_tick": 16}),
    (2048, 64, "uniform", "", 30, 24, {"max_p": 0, "suspect_ticks": 3}),
]


@pytest.mark.parametrize("n,k,exchange,kind,n_down,ticks,kw", CONFIGS)
def test_every_leaf_every_tick_matches_jax(n, k, exchange, kind, n_down, ticks, kw):
    jp, tp = _pair(n, k, exchange, **kw)
    down = _victims(n, n_down, seed=n + k)
    jf, tf = _faults(kind, n, down, seed=k)
    js, ts = _run_both(jp, tp, jf, tf, ticks, seed=k)
    if "drop" in kind:  # the queries read only ``up`` of the fault legs
        _assert_same_queries(js, ts, jf, tf, down[:6], f"{kind} final")


THREEFRY_CONFIGS = [
    # (n, k, exchange, faults, victims, ticks, params)
    (2048, 40, "shift", "drop", 20, 30, {"suspect_ticks": 5}),
    (2048, 64, "uniform", "drop node", 20, 24, {"suspect_ticks": 5}),
    (2048, 40, "shift", "group", 8, 30, {"heal_prob": 0.6, "suspect_ticks": 4}),
    (2048, 32, "shift", "drop", 16, 24, {"heal_prob": 0.0, "suspect_ticks": 3}),
]


@pytest.mark.parametrize("n,k,exchange,kind,n_down,ticks,kw", THREEFRY_CONFIGS)
def test_threefry_every_leaf_every_tick_matches_jax(n, k, exchange, kind, n_down, ticks, kw):
    """The JAX default stream: the five-way split, the shift or targets,
    the drop coin, the healer's split and draws (skipped at ``heal_prob``
    0) and the peers' split, [N, 3] randint and ping-req coins."""
    jp = jl.LifecycleParams(n=n, k=k, exchange=exchange, **kw)
    tp = tl.LifecycleParams(n=n, k=k, exchange=exchange, **kw)
    assert jp.rng == tp.rng == "threefry"
    down = _victims(n, n_down, seed=n + k)
    jf, tf = _faults(kind, n, down, seed=k)
    js, ts = _run_both(jp, tp, jf, tf, ticks, seed=k)
    _assert_same_queries(js, ts, jf, tf, down[:6], f"{kind} final")


# -- the candidate select --------------------------------------------------------


# -- the run loops ------------------------------------------------------------


# -- the kernels' plain versions against the JAX expressions they replace -----


# -- hazards -----------------------------------------------------------------


# -- refusals -----------------------------------------------------------------
