"""The port's lockstep conformance harness: the sequential oracle, the port's
vectorized engine and the JAX package's, in lockstep, bit for bit.

The five scenarios of ``tests/test_conformance.py`` that are not marked
slow, as one parametrised test: ``ringpop_tpu_torch.sim.conformance``'s
``LockstepRunner`` (its ``SequentialSwim`` and the port's ``FullViewSim``,
on the CPU) draws each tick's targets and peers from the oracle's pingable
sets, and the JAX package's ``FullViewSim`` gets the same injected draws;
every leaf of both engines is equal at every tick, and the oracle's state
equals the port's (``assert_identical``).  The 1k-node gate of BASELINE
(``test_1k_node_conformance_gate``) runs the same way as a slow test.  The
tolerance is none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ringpop_tpu.sim import conformance as jconf
from ringpop_tpu.sim import fullview as jfv
from ringpop_tpu_torch.sim import conformance as tconf
from ringpop_tpu_torch.sim import fullview as tfv
from ringpop_tpu_torch.swim.member import ALIVE, FAULTY, SUSPECT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_equal(jstate, tstate, what):
    got = tfv.state_to_numpy(tstate)
    for name, a, b in zip(jfv.FullViewState._fields, jstate, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b), (what, name, np.argwhere(a != b)[:5].tolist())


class Lockstep:
    """The port's LockstepRunner with the JAX engine fed the same draws."""

    def __init__(self, n, seed, **kw):
        self.runner = tconf.LockstepRunner(n=n, seed=seed, device="cpu", **kw)
        self.jax = jfv.FullViewSim(n=n, seed=seed, **kw)
        self.seq = self.runner.seq

    def run(self, ticks, up=None, group=None, check_every=1):
        tf = tfv.Faults(up=None if up is None else torch.as_tensor(up),
                        group=None if group is None else torch.as_tensor(group))
        jf = jfv.Faults(up=None if up is None else jnp.asarray(up),
                        group=None if group is None else jnp.asarray(group))
        for k in range(ticks):
            targets, peers = self.runner.draw()
            self.seq.step(targets, peers, tf)
            self.runner.vec.tick(tf, targets=torch.as_tensor(targets), peers=torch.as_tensor(peers))
            self.jax.tick(jf, targets=jnp.asarray(targets), peers=jnp.asarray(peers))
            _assert_equal(self.jax.state, self.runner.vec.state, f"tick {self.seq.tick_no}")
            if (k + 1) % check_every == 0:
                self.runner.assert_identical()


def _stable_cluster():
    Lockstep(n=32, seed=1).run(30)


def _dead_nodes_full_lifecycle():
    r = Lockstep(n=32, seed=2, suspect_ticks=4, faulty_ticks=8, tombstone_ticks=4)
    up = np.ones(32, bool)
    up[[3, 11, 19]] = False
    r.run(40, up=up)
    seq_view = r.seq.nodes[0].view
    assert all(seq_view.get(d, (ALIVE, 0))[0] != ALIVE or d not in seq_view for d in (3, 11, 19))


def _kill_then_revive_refutation():
    r = Lockstep(n=24, seed=3, suspect_ticks=6)
    up = np.ones(24, bool)
    up[5] = False
    r.run(10, up=up)
    assert any(n.view.get(5, (ALIVE, 0))[0] != ALIVE for n in r.seq.nodes)
    up[5] = True
    r.run(25)
    assert all(n.view[5][0] == ALIVE and n.view[5][1] > 0 for n in r.seq.nodes if 5 in n.view)


def _partition_then_heal():
    n = 32
    r = Lockstep(n=n, seed=4, suspect_ticks=4, faulty_ticks=1000)
    group = np.zeros(n, np.int32)
    group[n // 2:] = 1
    r.run(25, group=group)
    r.run(40)


def _packet_level_asymmetry_via_groups():
    n = 30
    r = Lockstep(n=n, seed=5, suspect_ticks=3)
    r.run(20, group=np.asarray(np.arange(n) % 3, np.int32))
    r.run(30)


SCENARIOS = {
    "stable_cluster": _stable_cluster,
    "dead_nodes_full_lifecycle": _dead_nodes_full_lifecycle,
    "kill_then_revive_refutation": _kill_then_revive_refutation,
    "partition_then_heal": _partition_then_heal,
    "packet_level_asymmetry_via_groups": _packet_level_asymmetry_via_groups,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_lockstep_scenario_matches_oracle_and_jax(scenario):
    SCENARIOS[scenario]()


def test_runner_alone_and_the_oracle_max_p():
    """The port's runner on its own (its ``run`` and ``tick``), and the
    oracle's integer maxP against the float32 expression at the counts a
    run reaches."""
    r = tconf.LockstepRunner(n=12, seed=9, device="cpu", suspect_ticks=3)
    up = np.ones(12, bool)
    up[4] = False
    r.run(12, faults=tfv.Faults(up=torch.as_tensor(up)), check_every=3)
    assert any(node.view.get(4, (ALIVE, 0))[0] in (SUSPECT, FAULTY) for node in r.seq.nodes)
    r.run(6)
    r.assert_identical()
    num = np.arange(0, 1001, dtype=np.int32)
    want = np.asarray((15 * jnp.ceil(jnp.log10(num.astype(jnp.float32) + 1.0))).astype(jnp.int32))
    assert np.array_equal((15 * tfv.decimal_digits(num)).astype(np.int32), want)


def test_runner_draws_equal_the_jax_runner_draws():
    """The port's ``LockstepRunner.draw`` is the JAX runner's: at one seed,
    through crashes, a partition and a heal, both runners draw the same
    targets and peers every tick, and their oracles stay equal."""
    n = 24
    jr = jconf.LockstepRunner(n=n, seed=5, suspect_ticks=3, faulty_ticks=6, tombstone_ticks=4)
    tr = tconf.LockstepRunner(n=n, seed=5, device="cpu", suspect_ticks=3, faulty_ticks=6, tombstone_ticks=4)
    up = np.ones(n, bool)
    up[[3, 17]] = False
    group = np.where(np.arange(n) < n // 2, 0, 1).astype(np.int32)
    legs = [(up, None, 10), (None, group, 8), (None, None, 6)]
    pools_changed = False
    for leg_up, leg_group, ticks in legs:
        jf = jfv.Faults(up=None if leg_up is None else jnp.asarray(leg_up),
                        group=None if leg_group is None else jnp.asarray(leg_group))
        tf = tfv.Faults(up=None if leg_up is None else torch.as_tensor(leg_up),
                        group=None if leg_group is None else torch.as_tensor(leg_group))
        for _ in range(ticks):
            (jt, jp), (tt, tp) = jr.draw(), tr.draw()
            assert np.array_equal(jt, tt) and np.array_equal(jp, tp), jr.seq.tick_no
            jr.seq.step(jt, jp, jf)
            tr.seq.step(tt, tp, tf)
            for name, a, b in zip(tfv.PLANES, jr.seq.as_arrays(), tr.seq.as_arrays()):
                assert np.array_equal(a, b), (jr.seq.tick_no, name)
            pools_changed |= any(node.view.get(3, (ALIVE, 0))[0] != ALIVE for node in tr.seq.nodes)
    # the draws saw the pools change: a crashed node left the pingable sets
    assert pools_changed


def test_assert_identical_names_the_cell_that_diverged():
    r = tconf.LockstepRunner(n=8, seed=1, device="cpu")
    r.run(3)
    r.vec.state.pcount[2, 5] += 1
    r.vec.state.has_change[2, 5] = True
    r.seq.nodes[2].changes[5] = 0
    with pytest.raises(AssertionError, match=r"pcount diverged at cells \[\[2, 5\]\]"):
        r.assert_identical()


@pytest.mark.slow
def test_1k_node_conformance_gate():
    """The BASELINE gate on the port: bit-identical member states vs the
    sequential reference semantics at 1k nodes, through a kill + recovery
    cycle (``tests/test_conformance.py``'s schedule)."""
    n = 1000
    r = tconf.LockstepRunner(n=n, seed=7, device="cpu", suspect_ticks=4, faulty_ticks=30, tombstone_ticks=8)
    up = np.ones(n, bool)
    up[[99, 499, 999]] = False
    r.run(12, faults=tfv.Faults(up=torch.as_tensor(up)), check_every=4)
    r.run(8, check_every=4)
    r.assert_identical()
