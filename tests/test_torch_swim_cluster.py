"""The port's SWIM host stack (``ringpop_tpu_torch/swim``) against the JAX
package's, cluster by cluster, on the CPU.

Each case is a scene of ``tests/test_swim_cluster.py`` or of the SWIM half of
``tests/test_heal_and_tcp.py``, written once against
:func:`torch_swim_harness.package` and run on both packages: in-process
clusters on a ``LocalNetwork`` under mock clocks with fixed seeds, driven a
protocol period at a time.  The scene's own assertions hold on both, and
the port's record equals the JAX run's: the digest of every node's sorted
``(address, status, incarnation)`` members after each tick, the final
statuses, incarnations and membership checksums.  The TCP scene binds
ephemeral ports, so it compares the members renamed by node index.
"""

import asyncio

import pytest
import torch

from torch_swim_harness import (
    JAX,
    PORT,
    Trace,
    bootstrap_nodes,
    converged,
    make_node,
    make_nodes,
    member_statuses,
    outcome,
    package,
    run,
    tick_all,
    wait_for_convergence,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both(scene, *args):
    """Run ``scene`` on the JAX package and on the port; the records must be
    equal.  Returns the port's record."""
    want = run(scene(package(JAX), *args))
    got = run(scene(package(PORT), *args))
    assert got == want
    return got


async def _boot_converged(ns, n, network=None, trace=None):
    nodes = make_nodes(ns, n, network)
    await bootstrap_nodes(ns, nodes)
    if trace is not None:
        trace.record(nodes)
    # a single node has no one to disseminate its own change to
    ticks = await wait_for_convergence(nodes, trace) if n > 1 else 0
    return nodes, ticks


async def scene_bootstrap(ns, n):
    trace = Trace()
    nodes, ticks = await _boot_converged(ns, n, trace=trace)
    for node in nodes:
        assert node.ready()
        assert node.member_count() == n
        assert node.count_reachable_members() == n
        assert all(s == ns.member.ALIVE for s in member_statuses(node).values())
    assert len({node.memberlist.checksum() for node in nodes}) == 1
    return {"ticks": ticks, "trace": trace.ticks, "outcome": outcome(nodes)}


@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_bootstrap_converges_as_the_jax_cluster(n):
    rec = both(scene_bootstrap, n)
    assert len(rec["outcome"]) == n


async def scene_suspect_declaration(ns):
    trace = Trace()
    nodes, _ = await _boot_converged(ns, 4, trace=trace)
    victim, declarer = nodes[3], nodes[0]
    member = declarer.memberlist.member(victim.address)
    nodes[0].channel.network.black_hole(victim.address)
    declarer.memberlist.make_suspect(victim.address, member.incarnation)
    assert member_statuses(declarer)[victim.address] == ns.member.SUSPECT
    others = nodes[:3]
    for _ in range(30):
        await tick_all(others, trace)
        if all(member_statuses(n)[victim.address] == ns.member.SUSPECT for n in others):
            break
    for n in others:
        assert member_statuses(n)[victim.address] == ns.member.SUSPECT
    return {"trace": trace.ticks, "outcome": outcome(nodes)}


def test_suspect_declaration_disseminates():
    both(scene_suspect_declaration)


async def scene_refutation(ns):
    trace = Trace()
    nodes, _ = await _boot_converged(ns, 3, trace=trace)
    victim = nodes[2]
    old_inc = victim.incarnation()
    member = nodes[0].memberlist.member(victim.address)
    nodes[0].memberlist.make_suspect(victim.address, member.incarnation)
    for _ in range(30):
        await tick_all(nodes, trace)
        if victim.incarnation() > old_inc:
            break
    assert victim.incarnation() > old_inc
    assert member_statuses(victim)[victim.address] == ns.member.ALIVE
    await wait_for_convergence(nodes, trace)
    for n in nodes:
        assert member_statuses(n)[victim.address] == ns.member.ALIVE
    return {"trace": trace.ticks, "outcome": outcome(nodes), "refuted": victim.incarnation() - old_inc}


def test_refutation_on_suspect():
    both(scene_refutation)


async def scene_black_hole(ns, rejoin):
    network = ns.LocalNetwork()
    trace = Trace()
    nodes, _ = await _boot_converged(ns, 3 if rejoin else 4, network, trace)
    victim, alive = nodes[-1], nodes[:-1]
    network.black_hole(victim.address)
    suspect_ticks = 0
    for _ in range(40):
        await tick_all(alive, trace)
        suspect_ticks += 1
        if all(member_statuses(n)[victim.address] == ns.member.SUSPECT for n in alive):
            break
    for n in alive:
        assert member_statuses(n)[victim.address] == ns.member.SUSPECT
        n.clock.advance(6.0)
    for n in alive:
        assert member_statuses(n)[victim.address] == ns.member.FAULTY
    trace.record(alive)
    if rejoin:
        network.unblack_hole(victim.address)
        victim.memberlist.reincarnate()
        for _ in range(60):
            await tick_all(nodes, trace)
            if converged(nodes) and all(member_statuses(n)[victim.address] == ns.member.ALIVE for n in nodes):
                break
        for n in nodes:
            assert member_statuses(n)[victim.address] == ns.member.ALIVE
    return {"suspect_ticks": suspect_ticks, "trace": trace.ticks, "outcome": outcome(nodes)}


@pytest.mark.parametrize("rejoin", [False, True], ids=["black_hole_to_faulty", "faulty_rejoins"])
def test_failure_detection_and_recovery(rejoin):
    both(scene_black_hole, rejoin)


async def scene_join_refusals(ns):
    network = ns.LocalNetwork()
    a = make_node(ns, network, "127.0.0.1:3000", app="appA")
    b = make_node(ns, network, "127.0.0.1:3001", app="appB")
    await bootstrap_nodes(ns, [a])
    await bootstrap_nodes(ns, [b])
    errors = []
    with pytest.raises(ns.CallError, match="app") as e:
        await ns.send_join_request(b, a.address, 0.5)
    errors.append(str(e.value))
    with pytest.raises(ns.CallError, match="itself") as e:
        body = {"app": "appA", "source": a.address, "incarnationNumber": 1, "timeout": 0.5}
        await a.channel.call(a.address, "ringpop", "/protocol/join", body, timeout=0.5)
    errors.append(str(e.value))
    return {"errors": errors, "outcome": outcome([a, b])}


def test_join_rejects_self_and_wrong_app():
    both(scene_join_refusals)


async def scene_full_sync(ns):
    trace = Trace()
    nodes, _ = await _boot_converged(ns, 2, trace=trace)
    ghost = ns.Change(address="127.0.0.1:9999", incarnation=1, status=ns.member.ALIVE, source="fiat")
    nodes[0].memberlist.update([ghost])
    nodes[0].disseminator.clear_changes()
    assert nodes[0].memberlist.checksum() != nodes[1].memberlist.checksum()
    await wait_for_convergence(nodes, trace)
    assert nodes[1].memberlist.member("127.0.0.1:9999") is not None
    return {"trace": trace.ticks, "outcome": outcome(nodes)}


def test_full_sync_repairs_divergence():
    both(scene_full_sync)


async def scene_eviction_chain(ns):
    network = ns.LocalNetwork()
    nodes, _ = await _boot_converged(ns, 3, network)
    victim, watcher = nodes[2], nodes[0]
    network.black_hole(victim.address)
    m = watcher.memberlist.member(victim.address)
    watcher.memberlist.make_suspect(victim.address, m.incarnation)
    seen = []
    for dt, want in ((6.0, ns.member.FAULTY), (24 * 3600 + 1, ns.member.TOMBSTONE)):
        watcher.clock.advance(dt)
        assert member_statuses(watcher)[victim.address] == want
        seen.append(outcome([watcher]))
    watcher.clock.advance(61)
    assert watcher.memberlist.member(victim.address) is None
    seen.append(outcome([watcher]))
    return {"seen": seen}


def test_state_transition_chain_to_eviction():
    both(scene_eviction_chain)


async def scene_admin(ns):
    nodes, _ = await _boot_converged(ns, 2)
    a, b = nodes
    replies = []
    res = await a.channel.call(b.address, "ringpop", "/admin/tick", {}, timeout=1.0)
    assert res["checksum"] == b.memberlist.checksum()
    replies.append(res)
    res = await a.channel.call(b.address, "ringpop", "/admin/member/leave", {}, timeout=1.0)
    assert res["status"] == "ok" and member_statuses(b)[b.address] == ns.member.LEAVE
    replies.append(res)
    b.clock.advance(0.1)
    res = await a.channel.call(b.address, "ringpop", "/admin/member/join", {}, timeout=1.0)
    assert res["status"] == "rejoined" and member_statuses(b)[b.address] == ns.member.ALIVE
    replies.append(res)
    m = b.memberlist.member(a.address)
    b.memberlist.make_faulty(a.address, m.incarnation)
    replies.append(await a.channel.call(b.address, "ringpop", "/admin/reap", {}, timeout=1.0))
    assert member_statuses(b)[a.address] == ns.member.TOMBSTONE
    replies.append(await a.channel.call(b.address, "ringpop", "/admin/gossip/tick", {}, timeout=1.0))
    return {"replies": replies, "outcome": outcome(nodes)}


def test_admin_handlers():
    both(scene_admin)


async def scene_leave_rejoin(ns):
    trace = Trace()
    nodes, _ = await _boot_converged(ns, 3, trace=trace)
    leaver = nodes[2]
    leaver.memberlist.make_leave(leaver.address, leaver.incarnation())
    await wait_for_convergence(nodes, trace)
    for n in nodes[:2]:
        assert member_statuses(n)[leaver.address] == ns.member.LEAVE
    leaver.memberlist.reincarnate()
    await wait_for_convergence(nodes, trace)
    for n in nodes:
        assert member_statuses(n)[leaver.address] == ns.member.ALIVE
    return {"trace": trace.ticks, "outcome": outcome(nodes)}


def test_leave_rejoin_cycle_via_gossip():
    both(scene_leave_rejoin)


async def scene_packet_loss(ns):
    network = ns.LocalNetwork(seed=7)
    network.drop_rate = 0.05
    trace = Trace()
    nodes = make_nodes(ns, 5, network)
    await bootstrap_nodes(ns, nodes)
    ticks = await wait_for_convergence(nodes, trace, max_ticks=400)
    for n in nodes:
        assert n.count_reachable_members() == 5
    return {"ticks": ticks, "trace": trace.ticks, "outcome": outcome(nodes)}


def test_packet_loss_still_converges():
    both(scene_packet_loss)


async def scene_first_seen_tombstone(ns):
    nodes, _ = await _boot_converged(ns, 2)
    ghost = ns.Change(address="127.0.0.1:9998", incarnation=1, status=ns.member.TOMBSTONE, source="fiat")
    assert nodes[0].memberlist.update([ghost]) == []
    assert nodes[0].memberlist.member("127.0.0.1:9998") is None
    return {"outcome": outcome(nodes)}


def test_first_seen_tombstone_is_refused():
    both(scene_first_seen_tombstone)


# -- partition healing and the TCP transport (tests/test_heal_and_tcp.py) ----


def test_nodes_that_need_to_reincarnate():
    results = []
    for root in (JAX, PORT):
        ns = package(root)
        ma = [ns.Change(address="a:1", incarnation=5, status=ns.member.ALIVE),
              ns.Change(address="b:2", incarnation=5, status=ns.member.FAULTY)]
        mb = [ns.Change(address="a:1", incarnation=4, status=ns.member.FAULTY),
              ns.Change(address="b:2", incarnation=5, status=ns.member.ALIVE)]
        for_a, for_b = ns.heal.nodes_that_need_to_reincarnate(ma, mb)
        assert [c.address for c in for_b] == ["b:2"] and for_a == []
        results.append([[c.to_wire() for c in for_a], [c.to_wire() for c in for_b]])
    assert results[0] == results[1]


def _partition_by_fiat(group_a, group_b):
    """Write Faulty states directly into memberlists (reference
    heal_partition_test.go:420-428 AddPartitionWithStatus)."""
    for side, other_side in ((group_a, group_b), (group_b, group_a)):
        for node in side:
            for other in other_side:
                m = node.memberlist.member(other.address)
                node.memberlist.make_faulty(other.address, m.incarnation)
                node.disseminator.clear_change(other.address)


async def scene_heal(ns, n, split, via_healer):
    network = ns.LocalNetwork()
    trace = Trace()
    nodes, _ = await _boot_converged(ns, n, network, trace)
    side_a, side_b = nodes[:split], nodes[split:]
    _partition_by_fiat(side_a, side_b)
    assert member_statuses(side_a[0])[side_b[0].address] == ns.member.FAULTY
    assert member_statuses(side_b[0])[side_a[0].address] == ns.member.FAULTY
    healed = []
    if via_healer:
        healed.append(await nodes[0].healer.heal())
        assert healed[0]
    for attempt in range(10):
        if via_healer:
            healed.append(await nodes[0].healer.heal())
        else:
            healed.append(await ns.heal.attempt_heal(side_a[0], side_b[0].address))
        for _ in range(40):
            await tick_all(nodes, trace)
            if converged(nodes):
                break
        if all(s == ns.member.ALIVE for node in nodes for s in member_statuses(node).values()):
            break
    for node in nodes:
        assert all(s == ns.member.ALIVE for s in member_statuses(node).values())
    return {"healed": healed, "trace": trace.ticks, "outcome": outcome(nodes)}


@pytest.mark.parametrize("n,split,via_healer", [(4, 2, False), (3, 1, True)],
                         ids=["attempt_heal_with_faulties", "healer_targets_faulty_and_unknown"])
def test_partition_heal(n, split, via_healer):
    both(scene_heal, n, split, via_healer)


async def scene_tcp_two_nodes(ns):
    channels = [ns.TCPChannel(app="tcp-test") for _ in range(2)]
    for ch in channels:
        await ch.listen()
    nodes = [ns.Node("tcp-test", ch.hostport, ch, ns.NodeOptions(clock=ns.MockClock(1e6), seed=i))
             for i, ch in enumerate(channels)]
    names = {n.address: f"node{i}" for i, n in enumerate(nodes)}
    hosts = [n.address for n in nodes]

    async def boot(node):
        await node.bootstrap(ns.BootstrapOptions(discover_provider=hosts, join_timeout=2.0))
        node.gossip.stop()
        node.healer.stop()

    await asyncio.gather(*(boot(n) for n in nodes))
    for _ in range(30):
        await tick_all(nodes)
        if converged(nodes):
            break
    assert converged(nodes)
    for n in nodes:
        assert n.member_count() == 2
    out = outcome(nodes, names)
    for ch in channels:
        await ch.close()
    return {"outcome": out}


def test_tcp_two_node_swim_cluster():
    both(scene_tcp_two_nodes)
