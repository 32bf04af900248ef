"""The port's partition table and digest partials
(``ringpop_tpu_torch/parallel/partition.py``) against the JAX package's
``parallel/partition.py``, in one process (no ranks are started: a
``Mesh`` object names the rank whose block is taken).

* ``PARTITION_RULES`` rule for rule, and ``spec_for`` over every leaf name
  of ``DeltaState``, ``LifecycleState``, ``TelemetryState``,
  ``DeltaFaults`` and ``chaos.FaultPlan``; ``partition_spec`` over the
  port's state trees against the JAX trees';
* ``process_block`` over a grid, the divisibility error included;
* ``leaf_partial_sums`` over 1, 2 and 4 row blocks of a lifecycle and a
  delta state combine (``combine_leaf_partials``) to the JAX package's
  ``telemetry.tree_digest`` and the port's, and each block's vector equals
  the JAX function's; at ``lo * row_elems >= 2**32`` the flat index wraps
  as the JAX package's does.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ringpop_tpu.parallel import partition as jp
from ringpop_tpu.sim import chaos as jchaos, delta as jd, lifecycle as jl, telemetry as jt

from ringpop_tpu_torch.parallel import partition as tp
from ringpop_tpu_torch.parallel.mesh import Mesh
from ringpop_tpu_torch.sim import delta as td, lifecycle as tl, telemetry as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _names():
    names = set(jd.DeltaState._fields) | set(jl.LifecycleState._fields) | set(jt.TelemetryState._fields)
    names |= {f.name for f in dataclasses.fields(jd.DeltaFaults)} | set(jchaos.FaultPlan._fields)
    return sorted(names)


def test_rules_equal_the_jax_table():
    assert [(r, tuple(s)) for r, s in tp.PARTITION_RULES] == [(r, tuple(s)) for r, s in jp.PARTITION_RULES]


@pytest.mark.parametrize("prefix", ["", "state/", "0/"])
def test_spec_for_every_leaf_name(prefix):
    for name in _names():
        assert tuple(tp.spec_for(prefix + name)) == tuple(jp.spec_for(prefix + name)), name
    assert tp.spec_for("not_a_leaf") == tp.P() and tuple(jp.spec_for("not_a_leaf")) == ()


def _flat_specs(tree, leaf_type):
    import jax

    return [tuple(s) for s in jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, leaf_type))]


def test_partition_spec_over_state_trees():
    import jax
    from jax.sharding import PartitionSpec

    lparams = tl.LifecycleParams(n=64, k=32, rng="counter")
    tstate = tl.init_state(lparams, device="cpu")
    jstate = jl.init_state(jl.LifecycleParams(n=64, k=32, rng="counter"))
    tree = {"state": tstate, "telemetry": tt.zeros(lparams, tiers=True, device="cpu")}
    jtree = {"state": jstate, "telemetry": jt.zeros(jl.LifecycleParams(n=64, k=32, rng="counter"), tiers=True)}
    got = [tuple(s) for _, s in tp.named_leaves(tp.partition_spec(tree))]
    want = _flat_specs(jp.partition_spec(jtree), PartitionSpec)
    assert got == want
    assert [name for name, _ in tp.named_leaves(tree)] == [
        jp._path_name(path) for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    got_b = [tuple(s) for _, s in tp.named_leaves(tp.partition_spec(tree, batch_axes=1, batch_axis="batch"))]
    assert got_b == _flat_specs(jp.partition_spec(jtree, batch_axes=1, batch_axis="batch"), PartitionSpec)


def test_process_block_equals_jax():
    for n in (1, 8, 96, 1000):
        for nprocs in (1, 2, 3, 4, 8):
            for rank in range(nprocs):
                if n % nprocs:
                    with pytest.raises(ValueError, match="must divide"):
                        tp.process_block(n, rank, nprocs)
                    with pytest.raises(ValueError, match="must divide"):
                        jp.process_block(n, rank, nprocs)
                else:
                    assert tp.process_block(n, rank, nprocs) == jp.process_block(n, rank, nprocs)
    for rank in (-1, 4):
        with pytest.raises(ValueError, match="outside"):
            tp.process_block(8, rank, 4)


def _lifecycle_pair():
    """A lifecycle state with slots in flight, in both packages."""
    params = tl.LifecycleParams(n=128, k=64, suspect_ticks=3, rng="counter")
    up = np.ones(128, bool)
    up[[5, 70, 127]] = False
    faults = td.DeltaFaults(up=torch.as_tensor(up))
    state = tl.init_state(params, seed=2, device="cpu")
    for _ in range(12):
        state = tl.step(params, state, faults)
    jstate = jl.LifecycleState(*(jnp.asarray(x) for x in tl.state_to_numpy(state)))
    return state, jstate


def _delta_pair():
    params = td.DeltaParams(n=128, k=64, rng="counter")
    state = td.init_state(params, seed=4, device="cpu")
    for _ in range(5):
        state = td.step(params, state)
    return state, jd.DeltaState(*(jnp.asarray(x) for x in td.state_to_numpy(state)))


@pytest.mark.parametrize("engine", ["lifecycle", "delta"])
@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_partials_combine_to_the_tree_digest(engine, ranks):
    state, jstate = _lifecycle_pair() if engine == "lifecycle" else _delta_pair()
    n = state.learned.shape[0]
    partials = []
    for rank in range(ranks):
        mesh = Mesh(size=ranks, rank=rank, device=torch.device("cpu"), transport="gloo")
        lo, hi = mesh.block(n)
        block = tp.shard_put(state, mesh, n)
        got = tp.leaf_partial_sums(block, lo=lo, include_replicated=rank == 0)
        jblock = type(jstate)(*(
            x[lo:hi] if tuple(jp.spec_for(name))[:1] == ("node",) else x
            for name, x in zip(type(jstate)._fields, jstate)))
        want = np.asarray(jp.leaf_partial_sums(jblock, lo=lo, include_replicated=rank == 0))
        assert np.array_equal(got.numpy(), want.astype(np.int64)), rank
        partials.append(got)
    combined = tp.combine_leaf_partials(partials)
    assert combined == int(jt.tree_digest(jstate)) == int(tt.tree_digest(state))
    assert combined == jp.combine_leaf_partials([p.numpy().astype(np.uint32) for p in partials])


@pytest.mark.parametrize("lo", [2**31, 2**32 // 3 + 5, 2**30 + 7])
def test_partial_flat_index_wraps_past_2_32(lo):
    """A block whose global flat index starts past 2**32 (``lo * row_elems``
    wraps mod 2**32, as the JAX package's ``:372`` does)."""
    rng = np.random.default_rng(lo % 1000)
    plane = rng.integers(0, 2**32, size=(4, 3), dtype=np.uint32)
    pcount = rng.integers(-128, 127, size=(4, 9), dtype=np.int8)
    assert lo * 9 >= 2**32 or lo * 3 >= 2**32
    tree = {"learned": torch.as_tensor(plane.view(np.int32)), "pcount": torch.as_tensor(pcount)}
    got = tp.leaf_partial_sums(tree, lo=lo)
    want = jp.leaf_partial_sums({"learned": jnp.asarray(plane), "pcount": jnp.asarray(pcount)}, lo=lo)
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    direct = [int(tt.leaf_digest_sum_plain(tree["learned"], (lo * 3) % 2**32)),
              int(tt.leaf_digest_sum_plain(tree["pcount"], (lo * 9) % 2**32))]
    assert got.tolist() == direct


def test_multihost_bring_up_reads_its_arguments(monkeypatch):
    """``init_distributed`` with no address in its arguments or the
    environment stays single-process (False); an address without a world
    size and rank is refused; the transport rule takes gloo without a card
    for every rank."""
    from ringpop_tpu_torch.parallel import multihost

    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not multihost.distributed_initialized()
    assert multihost.init_distributed() is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="world size"):
        multihost.init_distributed()
    with pytest.raises(ValueError, match="transport"):
        multihost.init_distributed("127.0.0.1:1", 2, 0, transport="mpi")
    assert multihost.default_transport(4, device="cpu") == "gloo"
    assert not multihost.distributed_initialized()
