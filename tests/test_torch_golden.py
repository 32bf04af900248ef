"""The port's engines at ``rng="threefry"`` against the frozen goldens and
the live JAX run, bit for bit.

Every configuration of ``tests/capture_lifecycle_golden.py`` and
``tests/capture_delta_golden.py`` (``CONFIGS``: both exchanges, packet
loss, partitions and the healer, the full suspect -> faulty -> tombstone ->
evict chain, slot saturation, K above and below 32, ``heal_prob`` 0, a
mid-run ``admit``, dead nodes, a stuck partition) runs through the port's
``step`` on the CPU with the JAX default stream, threefry: every leaf at
every tick equals the frozen capture (``golden_tools.load_golden``: the
capture of the running toolchain, else the legacy one; a plane the capture
lacks, the carried ``ride_ok``, is held to its invariant
``pcount < max_p``) and the live JAX run of the same configuration.
"""

import numpy as np
import pytest
import torch

from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu_torch.sim import delta as td
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim.packbits import unpack_bits

from tests import capture_delta_golden as cdg
from tests import capture_lifecycle_golden as clg
from tests import golden_tools
from tests.sim_faults import make_faults


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: more intra-op threads only contend with the other
    test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _as_bool_plane(arr: np.ndarray, k: int) -> np.ndarray:
    """[T, N, W] uint32 words -> [T, N, K] bool (a bool plane passes)."""
    if arr.dtype == np.bool_:
        return arr
    bits = (arr[..., :, None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(arr.shape[:-1] + (arr.shape[-1] * 32,))[..., :k].astype(bool)


def _run_port(engine, params, state, fault_sched, ticks, admits=None):
    """The port's trajectory: every leaf (numpy, the JAX package's dtypes)
    stacked over the ticks, under the capture's fault schedule."""
    frames = []
    for t in range(ticks):
        if admits and t in admits:
            state = engine.admit(params, state, admits[t])
        fkw = max((e for e in fault_sched if e[0] <= t), key=lambda e: e[0])[1]
        faults = engine.faults_from_numpy(make_faults(params.n, **fkw), device="cpu")
        state = engine.step(params, state, faults)
        frames.append(engine.state_to_numpy(state))
    return {f: np.stack([fr[i] for fr in frames]) for i, f in enumerate(type(state)._fields)}


def _check(name, fields, golden, live, got, k, max_p):
    for field in fields:
        want_live, have = live[field], got[field]
        assert have.dtype == want_live.dtype and have.shape == want_live.shape, (name, field)
        bad = np.flatnonzero((have != want_live).reshape(have.shape[0], -1).any(axis=1))
        assert bad.size == 0, f"{name}: {field} differs from the live JAX run from tick {bad[:1] + 1}"
        key = f"{name}/{field}"
        if key not in golden.files:
            assert field == "ride_ok", f"{name}: the golden lacks {field}"
            ride = _as_bool_plane(have, k)
            assert (ride == (got["pcount"] < max_p)).all(), f"{name}: ride_ok invariant"
            continue
        want = golden[key]
        if field in ("learned", "ride_ok"):
            want, have = _as_bool_plane(want, k), _as_bool_plane(have, k)
        bad = np.flatnonzero((have != want).reshape(have.shape[0], -1).any(axis=1))
        assert bad.size == 0, f"{name}: {field} differs from the frozen golden from tick {bad[:1] + 1}"


@pytest.fixture(scope="module")
def lifecycle_golden():
    return golden_tools.load_golden(clg.GOLDEN_PATH)


@pytest.fixture(scope="module")
def delta_golden():
    return golden_tools.load_golden(cdg.GOLDEN_PATH)


@pytest.mark.parametrize("name,pkw,fault_sched,admits,ticks,seed", clg.CONFIGS, ids=[c[0] for c in clg.CONFIGS])
def test_lifecycle_threefry_reproduces_the_golden(lifecycle_golden, name, pkw, fault_sched, admits, ticks, seed):
    params = tl.LifecycleParams(**pkw)
    assert params.rng == "threefry"
    live = clg.run_config(pkw, fault_sched, admits, ticks, seed)
    got = _run_port(tl, params, tl.init_state(params, seed=seed, device="cpu"), fault_sched, ticks, admits)
    _check(name, tl.LifecycleState._fields, lifecycle_golden, live, got, params.k, td.clamped_max_p(params))


@pytest.mark.parametrize("name,pkw,sources,fault_sched,ticks,seed", cdg.CONFIGS, ids=[c[0] for c in cdg.CONFIGS])
def test_delta_threefry_reproduces_the_golden(delta_golden, name, pkw, sources, fault_sched, ticks, seed):
    params = td.DeltaParams(**pkw)
    assert params.rng == "threefry"
    live = cdg.run_config(pkw, sources, fault_sched, ticks, seed)
    got = _run_port(td, params, td.init_state(params, seed=seed, sources=sources, device="cpu"), fault_sched, ticks)
    _check(name, td.DeltaState._fields, delta_golden, live, got, params.k, td.clamped_max_p(params))


def test_the_golden_plane_is_what_the_port_unpacks():
    """The frozen ``learned`` is a bool plane or uint32 words; the port's
    int32 words unpack to the same bits as ``_as_bool_plane`` reads."""
    words = torch.tensor([[0x8000_0001, 0x0000_00F0]], dtype=torch.int64).to(torch.int32)
    want = _as_bool_plane(np.array([[0x8000_0001, 0x0000_00F0]], np.uint32), 40)
    assert np.array_equal(unpack_bits(words, 40).numpy(), want)
    assert jl.LifecycleState._fields == tl.LifecycleState._fields and jd.DeltaState._fields == td.DeltaState._fields
