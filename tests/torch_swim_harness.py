"""One multi-node harness for the host stack of both packages.

``tests/swim_utils.py`` drives JAX-package nodes: real channels on an
in-process network, mock clocks, and every node's protocol period ticked in
turn until the checksums agree (reference ``swim/test_utils.go:164-199``).
This copy takes the package as an argument — :func:`package` gathers the
classes of ``ringpop_tpu`` or of ``ringpop_tpu_torch`` under one set of
names — so a test runs the same script on both and compares what it
records: a digest of every node's sorted ``(address, status, incarnation)``
members after each tick (:class:`Trace`), and the final statuses,
incarnations and checksums (:func:`outcome`).
"""

from __future__ import annotations

import asyncio
import hashlib
import importlib
from types import SimpleNamespace
from typing import Optional

_PACKAGES: dict[str, SimpleNamespace] = {}


def package(root: str) -> SimpleNamespace:
    """The host stack's classes and functions of ``root`` (``ringpop_tpu``
    or ``ringpop_tpu_torch``) under one set of names."""
    if root in _PACKAGES:
        return _PACKAGES[root]

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    net, member, node = mod("net"), mod("swim.member"), mod("swim.node")
    ns = SimpleNamespace(
        root=root,
        module=mod,
        LocalNetwork=net.LocalNetwork,
        LocalChannel=net.LocalChannel,
        TCPChannel=net.TCPChannel,
        CallError=net.CallError,
        Node=node.Node,
        NodeOptions=node.NodeOptions,
        BootstrapOptions=node.BootstrapOptions,
        StateTimeouts=mod("swim.state_transitions").StateTimeouts,
        MockClock=mod("util.clock").MockClock,
        Member=member.Member,
        Change=member.Change,
        member_to_change=member.member_to_change,
        state_id=member.state_id,
        member=member,
        swim_events=mod("swim.events"),
        send_join_request=mod("swim.join").send_join_request,
        send_ping=mod("swim.ping").send_ping,
        heal=mod("swim.heal"),
        Ringpop=mod("ringpop").Ringpop,
        Options=mod("options").Options,
        InMemoryStats=mod("options").InMemoryStats,
        errors=mod("errors"),
        snapshot=mod("sim.snapshot"),
        forward=mod("forward"),
        request_sender=mod("forward.request_sender"),
        router=mod("router"),
        replica=mod("replica"),
        adapter=mod("adapter"),
    )
    _PACKAGES[root] = ns
    return ns


JAX = "ringpop_tpu"
PORT = "ringpop_tpu_torch"


def run(coro):
    return asyncio.run(coro)


def make_node(ns, network, address: str, app: str = "test", seed: int = 0, suspect_timeout: float = 5.0):
    channel = ns.LocalChannel(network, address, app=app)
    opts = ns.NodeOptions(
        clock=ns.MockClock(start=1_000_000.0),
        seed=seed,
        state_timeouts=ns.StateTimeouts(suspect=suspect_timeout),
    )
    return ns.Node(app, address, channel, opts)


def make_nodes(ns, n: int, network=None, app: str = "test") -> list:
    network = network or ns.LocalNetwork()
    return [make_node(ns, network, f"127.0.0.1:{3000 + i}", app=app, seed=1000 + i) for i in range(n)]


async def bootstrap_nodes(ns, nodes: list, stop_gossip: bool = True, join_timeout: float = 0.5) -> None:
    hosts = [n.address for n in nodes]

    async def boot(node):
        await node.bootstrap(ns.BootstrapOptions(discover_provider=hosts, join_timeout=join_timeout))
        if stop_gossip:
            # tests drive the protocol synchronously (the reference's trick)
            node.gossip.stop()
            node.healer.stop()

    await asyncio.gather(*(boot(n) for n in nodes))


def member_rows(node) -> list[tuple]:
    return sorted((m.address, m.status, m.incarnation) for m in node.memberlist.get_members())


def member_statuses(node) -> dict[str, int]:
    return {m.address: m.status for m in node.memberlist.get_members()}


class Trace:
    """Per-tick digests: after each tick, the sha256 of every traced node's
    sorted members (and the ring checksum of a facade's node, when given)."""

    def __init__(self, rings: Optional[dict] = None):
        self.ticks: list[str] = []
        self.rings = rings or {}

    def record(self, nodes: list) -> None:
        h = hashlib.sha256()
        for n in nodes:
            h.update(repr((n.address, member_rows(n))).encode())
            ring = self.rings.get(n.address)
            if ring is not None:
                h.update(repr(ring.checksum()).encode())
        self.ticks.append(h.hexdigest()[:16])


def converged(nodes: list) -> bool:
    if any(n.disseminator.has_changes() for n in nodes):
        return False
    return len({n.memberlist.checksum() for n in nodes}) == 1


async def tick_all(nodes: list, trace: Optional[Trace] = None, advance: float = 0.001) -> None:
    """One protocol period on every node; clocks advance slightly so
    reincarnation bumps are strictly increasing."""
    for node in nodes:
        node.clock.advance(advance)
        await node.gossip.protocol_period()
    # drain reverse-full-sync tasks and other spawned work
    for _ in range(3):
        await asyncio.sleep(0)
    if trace is not None:
        trace.record(nodes)


async def wait_for_convergence(nodes: list, trace: Optional[Trace] = None, max_ticks: int = 200) -> int:
    for tick in range(max_ticks):
        if converged(nodes):
            return tick
        await tick_all(nodes, trace)
    raise AssertionError(
        f"no convergence after {max_ticks} ticks; checksums="
        f"{[n.memberlist.checksum() for n in nodes]} "
        f"changes={[n.disseminator.changes_count() for n in nodes]}"
    )


def outcome(nodes: list, names: Optional[dict] = None) -> dict:
    """Each node's final members, incarnation and checksum (addresses
    renamed through ``names`` when given)."""
    name = (lambda a: names.get(a, a)) if names is not None else (lambda a: a)
    return {
        name(n.address): {
            "members": sorted((name(a), s, i) for a, s, i in member_rows(n)),
            "incarnation": n.incarnation(),
            "checksum": None if names is not None else n.memberlist.checksum(),
        }
        for n in nodes
    }
