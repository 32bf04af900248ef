"""The port's snapshots and fleet carry (``ringpop_tpu_torch/sim/snapshot.py``)
against the JAX package's, on the CPU.

A snapshot written by either package loads into the other, bit for bit,
for the lifecycle, delta and full-view states (the file holds the JAX
dtypes: uint32 planes and key); a resumed port run steps on exactly as the
unbroken one; the pre-round-3 migration (no ``ride_ok``, an unpacked bool
``learned``) rebuilds what the JAX package rebuilds, warning alike without
params; type, field and magic validation; the carry store round-trips
nested structures with None legs and refuses a shape or dtype drift; and
the unported routes refuse by their ROADMAP item.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import delta as jd
from ringpop_tpu.sim import fullview as jf
from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu.sim import snapshot as jsnap
from ringpop_tpu_torch.sim import delta as td
from ringpop_tpu_torch.sim import fullview as tf
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim import snapshot as tsnap
from ringpop_tpu_torch.sim import telemetry as tt

CPU = torch.device("cpu")

# engine -> (port module, JAX module, port params, JAX state class, faults, port ticks)
ENGINES = {
    "delta": (td, jd, lambda: td.DeltaParams(n=64, k=40, rng="counter"), jd.DeltaState),
    "fullview": (tf, jf, lambda: tf.FullViewParams(n=16), jf.FullViewState),
    "lifecycle": (tl, jl, lambda: tl.LifecycleParams(n=48, k=40, suspect_ticks=4), jl.LifecycleState),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stepped(engine: str, ticks: int = 5):
    mod, _, params_fn, _ = ENGINES[engine]
    params = params_fn()
    state = mod.init_state(params, seed=3, device=CPU)
    faults = ()
    if engine == "lifecycle":
        up = torch.ones(params.n, dtype=torch.bool)
        up[3] = False
        faults = (td.DeltaFaults(up=up),)
    for _ in range(ticks):
        state = mod.step(params, state, *faults)
    return params, state, faults


def port_to_numpy(engine: str, state):
    return ENGINES[engine][0].state_to_numpy(state)


def trees_equal(a, b) -> bool:
    return all(np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_snapshots_cross_both_ways_and_resume(tmp_path, engine):
    mod, jmod, _, jcls = ENGINES[engine]
    params, state, faults = stepped(engine)
    want = port_to_numpy(engine, state)
    # the port writes, the JAX package reads
    path = str(tmp_path / "port.npz")
    tsnap.save_state(path, state, params=params)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        assert meta["magic"] == "ringpop_tpu-snapshot-v1" and meta["type"] == type(state).__name__
        assert data["key"].dtype == np.uint32
    assert trees_equal(jsnap.load_state(path, jcls), want)
    # the JAX package writes, the port reads
    jpath = str(tmp_path / "jax.npz")
    jsnap.save_state(jpath, jcls(*(jnp.asarray(x) for x in want)))
    back = tsnap.load_state(jpath, type(state), device=CPU)
    assert trees_equal(port_to_numpy(engine, back), want)
    # a resumed run steps on as the unbroken one
    resumed = tsnap.load_state(path, type(state), params=params, device=CPU)
    cont = state
    for _ in range(3):
        cont = mod.step(params, cont, *faults)
        resumed = mod.step(params, resumed, *faults)
    assert trees_equal(port_to_numpy(engine, resumed), port_to_numpy(engine, cont))


def forge_old_schema(path: str, state, cls_name: str, fields, k: int) -> None:
    """The pre-round-3 on-disk schema: ``learned`` unpacked bool[N, K], no
    ``ride_ok``, a meta without it (and without max_p)."""
    with np.load(path) as data:
        arrays = {f: data[f] for f in data.files if f not in ("__meta__", "ride_ok")}
    bits = np.unpackbits(arrays["learned"].view(np.uint8), axis=-1, bitorder="little")[:, :k]
    arrays["learned"] = bits.astype(bool)
    meta = json.dumps({"magic": "ringpop_tpu-snapshot-v1", "type": cls_name,
                       "fields": [f for f in fields if f != "ride_ok"]})
    np.savez_compressed(path, __meta__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays)


@pytest.mark.parametrize("engine", ["delta", "lifecycle"])
def test_pre_ride_ok_snapshot_migrates_as_the_jax_package_does(tmp_path, engine):
    mod, jmod, _, jcls = ENGINES[engine]
    params, state, faults = stepped(engine, ticks=6)
    path = str(tmp_path / "old.npz")
    tsnap.save_state(path, state)
    forge_old_schema(path, state, jcls.__name__, jcls._fields, params.k)
    want = port_to_numpy(engine, state)
    restored = tsnap.load_state(path, type(state), params=params, device=CPU)
    assert trees_equal(port_to_numpy(engine, restored), want)
    jparams = (jd.DeltaParams if engine == "delta" else jl.LifecycleParams)(n=params.n, k=params.k)
    assert trees_equal(jsnap.load_state(path, jcls, params=jparams), want)
    with pytest.warns(UserWarning, match="assuming the default dissemination"):
        restored_default = tsnap.load_state(path, type(state), device=CPU)
    assert trees_equal(port_to_numpy(engine, restored_default), want)
    # the loaded state steps on as the original
    cont, rcont = state, restored
    for _ in range(3):
        cont = mod.step(params, cont, *faults)
        rcont = mod.step(params, rcont, *faults)
    assert trees_equal(port_to_numpy(engine, rcont), port_to_numpy(engine, cont))


def test_meta_max_p_rides_the_migration(tmp_path):
    """A custom bound saved in the meta rebuilds the gate without params and
    without a warning, as in the JAX package."""
    import warnings

    params = td.DeltaParams(n=48, k=8, max_p=3, rng="counter")
    state = td.init_state(params, seed=5, device=CPU)
    for _ in range(6):
        state = td.step(params, state)
    path = str(tmp_path / "old.npz")
    tsnap.save_state(path, state, params=params)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {f: data[f] for f in data.files if f not in ("__meta__", "ride_ok")}
    assert meta["max_p"] == 3
    meta["fields"] = [f for f in td.DeltaState._fields if f != "ride_ok"]
    np.savez_compressed(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **arrays)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        restored = tsnap.load_state(path, td.DeltaState, device=CPU)
    assert trees_equal(td.state_to_numpy(restored), td.state_to_numpy(state))
    assert trees_equal(jsnap.load_state(path, jd.DeltaState), td.state_to_numpy(state))


def test_type_field_and_magic_validation(tmp_path):
    state = td.init_state(td.DeltaParams(n=16, k=4), seed=0, device=CPU)
    path = str(tmp_path / "snap.npz")
    tsnap.save_state(path, state)
    with pytest.raises(ValueError, match="snapshot holds DeltaState"):
        tsnap.load_state(path, tl.LifecycleState, device=CPU)
    np.savez(str(tmp_path / "bogus.npz"), a=np.zeros(3))
    with pytest.raises(ValueError, match="not a ringpop_tpu snapshot"):
        tsnap.load_state(str(tmp_path / "bogus.npz"), td.DeltaState, device=CPU)
    meta = json.dumps({"magic": "something-else", "type": "DeltaState", "fields": []})
    np.savez(str(tmp_path / "magic.npz"), __meta__=np.frombuffer(meta.encode(), dtype=np.uint8))
    with pytest.raises(ValueError, match="not a ringpop_tpu snapshot"):
        tsnap.load_state(str(tmp_path / "magic.npz"), td.DeltaState, device=CPU)
    with np.load(path) as data:
        arrays = {f: data[f] for f in data.files if f != "__meta__"}
    meta = json.dumps({"magic": "ringpop_tpu-snapshot-v1", "type": "DeltaState", "fields": ["learned", "tick"]})
    np.savez(str(tmp_path / "fields.npz"), __meta__=np.frombuffer(meta.encode(), dtype=np.uint8), **arrays)
    with pytest.raises(ValueError, match="field mismatch"):
        tsnap.load_state(str(tmp_path / "fields.npz"), td.DeltaState, device=CPU)


def test_carry_round_trips_nested_and_refuses_drift(tmp_path):
    """A nested carry with a None leg round-trips bit-exactly under the
    JAX package's leaf names and dtypes; a shape drift refuses."""
    params = tl.LifecycleParams(n=64, k=16)
    tel = tt.zeros(params, device=CPU)
    tel.piggybacked.fill_(-1)  # uint32 0xFFFFFFFF in the file
    states = tl.init_state(params, seed=2**32 + 9, device=CPU)
    carry = {"states": states, "telemetry": tel, "first": torch.tensor([1, -1, 3], dtype=torch.int32)}
    path = str(tmp_path / "carry")
    tsnap.save_carry_orbax(path, carry)
    assert os.listdir(path) == ["shard-00000.npz"]  # one process: one file
    with np.load(os.path.join(path, "shard-00000.npz")) as data:
        names = sorted(data.files)
        assert data["telemetry.piggybacked"].dtype == np.uint32 and data["telemetry.piggybacked"].max() == 2**32 - 1
        assert data["states.key"].dtype == np.uint32 and data["states.key"].tolist() == [0, 9]
        assert data["first"].dtype == np.int32
    assert "telemetry.suspects_by_tier" not in names and "states.learned" in names
    out = tsnap.load_carry_orbax(path, carry)
    assert isinstance(out["telemetry"], tt.TelemetryState) and out["telemetry"].suspects_by_tier is None
    flat_in, flat_out = tsnap._flatten_named(carry), tsnap._flatten_named(out)
    assert list(flat_in) == list(flat_out)
    for name, (leaf, _) in flat_in.items():
        got = flat_out[name][0]
        assert got.dtype == leaf.dtype and torch.equal(got, leaf), name
    with pytest.raises(ValueError, match="wrong fleet config"):
        tsnap.load_carry_orbax(path, dict(carry, first=torch.zeros(5, dtype=torch.int32)))
    with pytest.raises(ValueError, match="wrong fleet config"):
        tsnap.load_carry_orbax(path, dict(carry, extra=torch.zeros(1)))


def test_unported_routes_refuse_by_queue_item(tmp_path):
    """The membership export and import (A14) still refuse; the store behind
    the orbax routes (A12b) now round-trips a state and a carry at a small
    size (its sharded writes and restores are in
    tests/test_torch_snapshot_store.py and tests/test_torch_fleet_ckpt.py)."""
    state = tl.step(tl.LifecycleParams(n=8, k=8), tl.init_state(tl.LifecycleParams(n=8, k=8), device=CPU))
    assert tsnap.save_state_orbax(str(tmp_path / "state"), state, wait=True) is None
    back = tsnap.load_state_orbax(str(tmp_path / "state"), state)
    assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(state, back))
    carry = {"first": torch.tensor([1, -1], dtype=torch.int32), "states": state}
    tsnap.save_carry_orbax(str(tmp_path / "carry"), carry)
    out = tsnap.load_carry_orbax(str(tmp_path / "carry"), carry)
    assert torch.equal(out["first"], carry["first"]) and torch.equal(out["states"].key, state.key)
    with pytest.raises(NotImplementedError, match="A14"):
        tsnap.export_membership(None)
    with pytest.raises(NotImplementedError, match="A14"):
        tsnap.import_membership(None, [])


def test_load_state_defaults_to_the_card(tmp_path, monkeypatch):
    path = str(tmp_path / "snap.npz")
    tsnap.save_state(path, td.init_state(td.DeltaParams(n=16, k=4), seed=0, device=CPU))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsnap.load_state(path, td.DeltaState)
