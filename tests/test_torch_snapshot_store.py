"""The multi-process checkpoint store behind ``snapshot.save_state_orbax``
and ``load_state_orbax``, against the JAX package run unsharded.

A lifecycle state stepped on a (2, 2) mesh of gloo ranks (n 256, k 64:
each rank node rows block p and word block r; 8 ticks at the counter
stream with six nodes down, 1 % loss and a heal rate of 0.3) is saved by
its ranks, each writing only its own blocks.  It restores bit-equal to
the JAX package's unsharded state at (1, 1) (whole), at (4, 1) (on the
same ranks, each reading only its row block) and at (1, 2) (each rumor
rank's word block, read here on meshes of the ranks' coordinates, which
needs no collective).  A target of another shape or dtype raises.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from ringpop_tpu.sim import lifecycle as jl
from ringpop_tpu_torch.parallel import partition
from ringpop_tpu_torch.parallel.mesh import Mesh
from ringpop_tpu_torch.sim import lifecycle as tl
from ringpop_tpu_torch.sim import snapshot as tsnap

from test_torch_sharded import jax_faults, jax_params, spec
from torch_dist_worker import run_group

CPU = torch.device("cpu")
STORE = spec("lifecycle", 256, ticks=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("store") / "state")
    ranks = run_group(4, [("store", "state_store", dict(STORE, path=path))], shape=(2, 2), every_rank=True)
    return path, [r["store"] for r in ranks]


@functools.lru_cache(maxsize=None)
def jax_state():
    params = jax_params(STORE)
    state = jl.init_state(params, seed=STORE["seed"])
    run = jax.jit(functools.partial(jl._run_block, params), static_argnames="ticks")
    return [np.asarray(x) for x in run(state, jax_faults(STORE), ticks=STORE["ticks"])]


def example() -> tl.LifecycleState:
    """The whole state's shapes and dtypes, as meta tensors."""
    whole = tl.init_state(tl.LifecycleParams(n=STORE["n"], k=STORE["k"], rng="counter"), device=CPU)
    return tl.LifecycleState(*(torch.empty(x.shape, dtype=x.dtype, device="meta") for x in whole))


def assert_jax_equal(state):
    for field, a, b in zip(tl.LifecycleState._fields, tl.state_to_numpy(state), jax_state()):
        assert np.asarray(a).dtype == b.dtype and np.array_equal(a, b), field


def test_sharded_save_is_the_jax_state_and_each_rank_wrote_its_blocks(saved):
    path, ranks = saved
    for field, a, b in zip(tl.LifecycleState._fields, ranks[0]["whole"], jax_state()):
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    index = tsnap._store_index(path)
    # the planes: four blocks, one a rank; per-node vectors: two row blocks,
    # written by the rumor rank 0 of each; the rumor table and scalars once
    assert len(index["learned"]) == len(index["pcount"]) == 4
    assert len(index["base_inc"]) == 2 and len(index["r_subject"]) == len(index["key"]) == 1
    assert sorted(p[1] for p in index["learned"]) == [(0, 0), (0, 1), (128, 0), (128, 1)]


def test_restore_whole_at_one_rank(saved):
    assert_jax_equal(tsnap.load_state_orbax(saved[0], example(), device=CPU))


def test_restore_at_four_node_ranks(saved):
    assert all(r["restored_equal"] for r in saved[1])


def test_restore_at_two_rumor_ranks(saved):
    whole = tsnap.load_state_orbax(saved[0], example(), device=CPU)
    for r in (0, 1):
        mesh = Mesh(size=1, rank=0, device=CPU, transport="gloo", rumor_size=2, rumor_rank=r)
        block = tsnap.load_state_orbax(saved[0], example(), tl.state_shardings(mesh, k=STORE["k"]))
        want = partition.shard_put(whole, mesh, STORE["n"])
        assert all(torch.equal(a, b) and a.dtype == b.dtype for a, b in zip(block, want)), r
        assert block.learned.shape == (STORE["n"], 1) and block.r_subject.shape == (STORE["k"],)


def test_mismatched_target_raises(saved):
    ex = example()
    with pytest.raises(ValueError, match="wrong engine config"):
        tsnap.load_state_orbax(saved[0], ex._replace(learned=torch.empty(128, 2, dtype=torch.int32, device="meta")),
                               device=CPU)
    with pytest.raises(ValueError, match="wrong engine config"):
        tsnap.load_state_orbax(saved[0], ex._replace(base_inc=torch.empty(256, dtype=torch.int64, device="meta")),
                               device=CPU)
