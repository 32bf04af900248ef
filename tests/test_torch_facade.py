"""The port's facade (``ringpop_tpu_torch.ringpop.Ringpop``) and the glue over
it — ``router``, ``replica``, ``adapter`` and the scalar ``forward`` path —
against the JAX package's, on the CPU.

The cases of ``tests/test_facade.py`` and ``tests/test_forward_router_replica.py``,
each written once against :func:`torch_swim_harness.package` and run on
both packages.  The original assertions hold on both, and wherever the JAX
test checks a value the port's equals the JAX run's: the lifecycle states,
the per-tick members and ring checksums of the booted clusters, the
lookups and preference lists, ``handle_or_forward``'s answers, the stats
keys and gauges, the admin endpoints' replies, the router's clients, the
replicator's responses and the adapter's routing.
"""

import asyncio

import pytest
import torch

from test_forward_router_replica import Factory, FakeRingpop, FakeSender
from torch_swim_harness import JAX, PORT, Trace, converged, package, run, tick_all


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class MovingSender(FakeSender):
    """A ``FakeSender`` whose keys move to their new owners once ``after``
    look-ups have been answered: a scene ordered by the forwarder's own
    retries, not by a sleep racing them."""

    def __init__(self, lookups, moved, after):
        super().__init__(lookups=dict(lookups))
        self.moved = moved
        self.after = after
        self.calls = 0

    def lookup(self, key):
        if self.calls == self.after:
            self.lookups = dict(self.moved)
        self.calls += 1
        return super().lookup(key)


def both(scene, *args):
    want = run(scene(package(JAX), *args))
    got = run(scene(package(PORT), *args))
    assert got == want
    return got


def make_ringpop(ns, network, hostport, app="rp-test", stats=None, seed=0):
    ch = ns.LocalChannel(network, hostport, app=app)
    return ns.Ringpop(app, ch, ns.Options(stats_reporter=stats, clock=ns.MockClock(1e6), seed=seed))


async def boot_cluster(ns, n=3, app="rp-test", stats_for_first=None, trace=None):
    network = ns.LocalNetwork()
    rps = [make_ringpop(ns, network, f"127.0.0.1:{4000 + i}", app=app,
                        stats=stats_for_first if i == 0 else None, seed=i) for i in range(n)]
    hosts = [f"127.0.0.1:{4000 + i}" for i in range(n)]

    async def boot(rp):
        await rp.bootstrap(ns.BootstrapOptions(discover_provider=hosts, join_timeout=0.5))
        rp.node.gossip.stop()
        rp.node.healer.stop()

    await asyncio.gather(*(boot(rp) for rp in rps))
    nodes = [rp.node for rp in rps]
    if trace is not None:
        trace.rings.update({rp.who_am_i(): rp.ring for rp in rps})
    for _ in range(60):
        await tick_all(nodes, trace)
        if converged(nodes):
            break
    return network, rps


# -- the facade (tests/test_facade.py) ---------------------------------------


async def scene_lifecycle(ns):
    network = ns.LocalNetwork()
    rp = make_ringpop(ns, network, "127.0.0.1:4000")
    states = [rp.state.name]
    with pytest.raises(ns.errors.NotBootstrappedError):
        rp.lookup("k")
    events = []
    rp.register_listener(type("L", (), {"handle_event": lambda self, e: events.append(type(e).__name__)})())
    joined = await rp.bootstrap(ns.BootstrapOptions(discover_provider=["127.0.0.1:4000"]))
    states.append(rp.state.name)
    assert rp.ready() and rp.who_am_i() == "127.0.0.1:4000" and rp.app() == "rp-test"
    assert rp.uptime() >= 0
    rec = {"joined": joined, "lookup": rp.lookup("k"), "checksum": rp.checksum(),
           "members": rp.get_reachable_members(), "count": rp.count_reachable_members()}
    rp.destroy()
    states.append(rp.state.name)
    assert states == ["CREATED", "READY", "DESTROYED"]
    with pytest.raises(ns.errors.InvalidStateError):
        await rp.bootstrap(ns.BootstrapOptions(discover_provider=["127.0.0.1:4000"]))
    return {"states": states, "events": sorted(set(events)), **rec}


def test_lifecycle_states():
    rec = both(scene_lifecycle)
    assert "Ready" in rec["events"] and "Destroyed" in rec["events"]


def test_ephemeral_identity_and_channel_refused():
    for root in (JAX, PORT):
        ns = package(root)
        rp = ns.Ringpop("x", ns.LocalChannel(ns.LocalNetwork(), "127.0.0.1:0"), ns.Options(clock=ns.MockClock()))
        with pytest.raises(ns.errors.EphemeralIdentityError, match="ephemeral port"):
            rp._init()
        with pytest.raises(ValueError, match="channel is required"):
            ns.Ringpop("x", None)
    port = package(PORT)
    rp = port.module("ringpop").new("x", port.LocalChannel(port.LocalNetwork(), "127.0.0.1:5"), replica_points=7)
    assert rp.options.replica_points == 7


async def scene_membership_drives_ring(ns):
    trace = Trace()
    network, rps = await boot_cluster(ns, 3, trace=trace)
    for rp in rps:
        assert sorted(rp.ring.servers()) == sorted(r.who_am_i() for r in rps)
    assert len({rp.checksum() for rp in rps}) == 1
    victim = rps[2]
    m = rps[0].node.memberlist.member(victim.who_am_i())
    rps[0].node.memberlist.make_faulty(victim.who_am_i(), m.incarnation)
    assert victim.who_am_i() not in rps[0].ring.servers()
    return {"trace": trace.ticks, "checksums": [rp.checksum() for rp in rps],
            "servers": rps[0].ring.servers()}


def test_membership_drives_ring():
    both(scene_membership_drives_ring)


KEYS = [f"key-{i}" for i in range(64)] + ["alpha", "beta", "gamma", "delta", ""]


async def scene_lookups(ns):
    network, rps = await boot_cluster(ns, 3)
    for key in ("alpha", "beta", "gamma", "delta"):
        assert len({rp.lookup(key) for rp in rps}) == 1
    dests = rps[0].lookup_n("alpha", 2)
    assert len(dests) == 2 and len(set(dests)) == 2
    return {"one": [rps[0].lookup(k) for k in KEYS],
            "n": [rps[1].lookup_n(k, n) for k in KEYS for n in (1, 2, 3, 5)],
            "batch": rps[2].lookup_n_batch(KEYS, 3)}


def test_lookup_consistent_across_nodes():
    rec = both(scene_lookups)
    assert rec["batch"] == [rec["n"][4 * i + 2] for i in range(len(KEYS))]


async def scene_handle_or_forward(ns):
    network, rps = await boot_cluster(ns, 3)
    service, endpoint = "rp-test", "/app/echo"
    for rp in rps:
        me = rp.who_am_i()

        async def echo(body, headers, me=me):
            return {"served_by": me, "payload": body.get("payload")}

        rp.channel.register(service, endpoint, echo)
    out = []
    for i, key in enumerate(["some-key"] + KEYS[:16]):
        owner = rps[0].lookup(key)
        caller = next(rp for rp in rps if rp.who_am_i() != owner)
        handled, res = await caller.handle_or_forward(key, {"payload": i}, service, endpoint)
        assert not handled and res == {"served_by": owner, "payload": i}
        owner_rp = next(rp for rp in rps if rp.who_am_i() == owner)
        assert await owner_rp.handle_or_forward(key, {}, service, endpoint) == (True, None)
        # a forwarded request is handled where it lands
        assert await caller.handle_or_forward(key, {}, service, endpoint,
                                              headers={"ringpop-forwarded": "true"}) == (True, None)
        out.append((caller.who_am_i(), owner, res))
    return out


def test_handle_or_forward_routes_to_owner():
    both(scene_handle_or_forward)


async def scene_stats(ns):
    stats = ns.InMemoryStats()
    network, rps = await boot_cluster(ns, 2, stats_for_first=stats)
    rps[0].lookup("k")
    rps[0].lookup_n("k", 2)
    rps[0].lookup_n_batch(["k", "j"], 2)
    prefix = f"ringpop.{rps[0].who_am_i().replace(':', '_').replace('.', '_')}."
    assert any(k.startswith(prefix + "lookup") for k in stats.timers)
    assert any(k.startswith(prefix + "ping.send") for k in stats.counters)
    assert prefix + "ring.server-added" in stats.counters
    return {"counters": stats.counters, "gauges": stats.gauges,
            "timers": sorted((k, len(v)) for k, v in stats.timers.items())}


def test_stats_emitted():
    both(scene_stats)


async def scene_admin(ns):
    network, rps = await boot_cluster(ns, 2)
    client = ns.LocalChannel(network, "127.0.0.1:9999")
    target = rps[0].who_am_i()
    res = await client.call(target, "ringpop", "/health", {}, timeout=1.0)
    assert res == {"ok": True}
    lookup = await client.call(target, "ringpop", "/admin/lookup", {"key": "k"}, timeout=1.0)
    assert lookup["dest"] == rps[0].lookup("k")
    stats = await client.call(target, "ringpop", "/admin/stats", {}, timeout=1.0)
    assert stats["state"] == "ready"
    assert len(stats["membership"]["members"]) == 2
    assert sorted(stats["ring"]["servers"]) == sorted(r.who_am_i() for r in rps)
    assert stats["protocol"]["timing"]["count"] >= 1
    return {"lookup": lookup, "membership": stats["membership"], "ring": stats["ring"],
            "timing_count": stats["protocol"]["timing"]["count"], "keys": sorted(stats)}


def test_admin_endpoints():
    both(scene_admin)


async def scene_periodic_timers(ns):
    stats = ns.InMemoryStats()
    network, rps = await boot_cluster(ns, 2, stats_for_first=stats)
    rp = rps[0]
    prefix = f"ringpop.{rp.who_am_i().replace(':', '_').replace('.', '_')}."
    rp.node.clock.advance(5.5)
    assert prefix + "membership.checksum-periodic" in stats.gauges
    assert prefix + "ring.checksum-periodic" in stats.gauges
    before = stats.gauges[prefix + "membership.checksum-periodic"]
    rp.node.clock.advance(5.5)
    assert stats.gauges[prefix + "membership.checksum-periodic"] == before
    return {k: v for k, v in stats.gauges.items() if "periodic" in k}


def test_periodic_checksum_stat_timers():
    both(scene_periodic_timers)


# -- forwarding, router, replicator, adapter ---------------------------------
# (tests/test_forward_router_replica.py)


def test_forwarded_header_helpers():
    fwd = package(PORT).forward
    h = fwd.set_forwarded_header(None)
    assert fwd.has_forwarded_header(h) and h == package(JAX).forward.set_forwarded_header(None)
    assert not fwd.has_forwarded_header({})
    assert not fwd.has_forwarded_header(None)
    assert not fwd.has_forwarded_header({"ringpop-forwarded": "yes"})


async def scene_forward_success(ns):
    network = ns.LocalNetwork()
    server = ns.LocalChannel(network, "dest:1")
    seen = {}

    async def handler(body, headers):
        seen.update(headers=headers, body=body)
        return {"ok": 1}

    server.register("svc", "/ep", handler)
    fwd = ns.forward.Forwarder(FakeSender(lookups={"k": "dest:1"}), ns.LocalChannel(network, "me:1"))
    res = await fwd.forward_request({"a": 1}, "dest:1", "svc", "/ep", ["k"])
    assert res == {"ok": 1} and ns.forward.has_forwarded_header(seen["headers"]) and fwd.inflight == 0
    return {"res": res, "seen": seen}


def test_forward_success_and_header_set():
    both(scene_forward_success)


async def scene_forward_retries(ns, case):
    network = ns.LocalNetwork()
    client = ns.LocalChannel(network, "me:1")
    Opts = ns.forward.Options
    if case == "then_succeeds":
        async def handler(body, headers):
            return {"ok": 0}

        fwd = ns.forward.Forwarder(FakeSender(lookups={"k": "dest:1"}), client)

        async def bring_up_later():
            await asyncio.sleep(0.005)
            ns.LocalChannel(network, "dest:1").register("svc", "/ep", handler)

        task = asyncio.ensure_future(bring_up_later())
        res = await fwd.forward_request({"a": 1}, "dest:1", "svc", "/ep", ["k"],
                                        Opts(max_retries=2, retry_schedule=(0.01, 0.01), timeout=0.2))
        await task
        return {"res": res}
    if case == "exhausted":
        fwd = ns.forward.Forwarder(FakeSender(lookups={"k": "gone:9"}), client)
        with pytest.raises(ns.request_sender.MaxRetriesError) as e:
            await fwd.forward_request({}, "gone:9", "svc", "/ep", ["k"],
                                      Opts(max_retries=2, retry_schedule=(0.001, 0.001), timeout=0.05))
        return {"error": type(e.value).__name__}
    if case == "diverge":
        # the keys' owners move after the first retry's look-ups, so the
        # second retry finds them on two destinations
        sender = MovingSender({"k1": "gone:9", "k2": "gone:9"}, {"k1": "a:1", "k2": "b:2"}, after=2)
        fwd = ns.forward.Forwarder(sender, client)
        with pytest.raises(ns.request_sender.DestinationsDivergedError) as e:
            await fwd.forward_request({}, "gone:9", "svc", "/ep", ["k1", "k2"],
                                      Opts(max_retries=3, retry_schedule=(0.001,), timeout=0.05))
        return {"error": type(e.value).__name__, "lookups": sender.calls}

    async def handler(body, headers):
        return {"served": "new"}

    ns.LocalChannel(network, "new:1").register("svc", "/ep", handler)
    # the key's owner moves after the first retry's look-up, so the second
    # retry reroutes to it
    sender = MovingSender({"k": "gone:9"}, {"k": "new:1"}, after=1)
    fwd = ns.forward.Forwarder(sender, client)
    res = await fwd.forward_request({}, "gone:9", "svc", "/ep", ["k"],
                                    Opts(max_retries=2, retry_schedule=(0.001,), timeout=0.05,
                                         reroute_retries=True))
    return {"res": res, "lookups": sender.calls}


@pytest.mark.parametrize("case", ["then_succeeds", "exhausted", "diverge", "reroute"])
def test_forward_retries(case):
    rec = both(scene_forward_retries, case)
    rec.pop("lookups", None)
    want = {"then_succeeds": {"res": {"ok": 0}}, "exhausted": {"error": "MaxRetriesError"},
            "diverge": {"error": "DestinationsDivergedError"}, "reroute": {"res": {"served": "new"}}}
    assert rec == want[case]


def router_script(ns):
    out = []
    rp = FakeRingpop("a:1", {"k1": "a:1", "k2": "b:2", "k3": "b:2"})
    f = Factory()
    router = ns.router.Router(rp, f)
    out.append(router.get_client("k1"))
    out.append(router.get_client("k2"))
    router.get_client("k2")
    out.append(list(f.made))
    out.append(router.get_client_batch(["k1", "k2", "k3"]))
    out.append(router.get_client_batch([]))
    calls = []
    f2 = Factory()
    router2 = ns.router.Router(rp, f2, lookup_source=lambda keys: calls.append(list(keys)) or ["c:3" for _ in keys])
    out += [router2.get_client_batch(["k1", "k2"]), calls, f2.made, router2.get_client("k1")]
    router.handle_event(ns.swim_events.MemberlistChangesAppliedEvent(
        changes=[ns.Change(address="b:2", incarnation=1, status=ns.member.FAULTY)]))
    router.get_client("k2")
    out.append(list(f.made))
    return out


def test_router():
    got, want = router_script(package(PORT)), router_script(package(JAX))
    assert got == want
    assert got[0] == ("LOCAL", True) and got[1] == ("REMOTE(b:2)", False) and got[2] == ["b:2"]
    assert got[3] == [("LOCAL", True), ("REMOTE(b:2)", False), ("REMOTE(b:2)", False)]
    assert got[5] == [("REMOTE(c:3)", False), ("REMOTE(c:3)", False)] and got[8] == ("LOCAL", True)
    assert got[-1] == ["b:2", "b:2"]


def _replica_network(ns, dests=("a:1", "b:2", "c:3")):
    network = ns.LocalNetwork()
    served = []
    for d in dests:
        ch = ns.LocalChannel(network, d, app="svc")

        async def handler(body, headers, d=d):
            served.append(d)
            return {"from": d}

        ch.register("svc", "/op", handler)
    return network, ns.LocalChannel(network, "me:1", app="svc"), served


async def scene_replicator(ns, case):
    rep_mod = ns.replica
    Fopts = ns.forward.Options
    up = ("a:1",) if case in ("read_r", "write_below_quorum") else ("a:1", "b:2", "c:3")
    network, client, served = _replica_network(ns, up)
    sender = FakeSender(me="me:1", lookups={"k": ["a:1", "b:2", "c:3"]})
    rep = rep_mod.Replicator(sender, client, rng=__import__("random").Random(5))
    fopts = Fopts(max_retries=0, retry_schedule=(0.001,), timeout=0.05)
    if case == "parallel":
        responses = await rep.write(["k"], {"v": 1}, "/op")
        assert len(responses) == 3 and sorted(served) == ["a:1", "b:2", "c:3"]
    elif case == "read_r":
        responses = await rep.read(["k"], {}, "/op", fopts=fopts)
        assert len(responses) >= 1
    elif case == "write_below_quorum":
        with pytest.raises(rep_mod.NotEnoughResponsesError) as e:
            await rep.write(["k"], {}, "/op", fopts=fopts)
        return {"error": str(e.value)}
    else:
        mode = getattr(rep_mod.FanoutMode, case)
        responses = await rep.read(["k"], {}, "/op", opts=rep_mod.Options(fanout_mode=mode))
        assert len(responses) == 1 and len(served) == 1
    return {"responses": sorted((r.destination, r.keys, r.body) for r in responses), "served": sorted(served)}


@pytest.mark.parametrize("case", ["parallel", "read_r", "write_below_quorum", "SERIAL_SEQUENTIAL",
                                  "SERIAL_BALANCED"])
def test_replicator(case):
    both(scene_replicator, case)


async def scene_replicator_on_the_facade(ns):
    """The replicator over a live facade: ``lookup_n_batch`` groups several
    keys' preference lists in one ring walk."""
    network, rps = await boot_cluster(ns, 3, app="svc")
    for rp in rps:
        async def handler(body, headers, me=rp.who_am_i()):
            return {"from": me, "keys": body.get("keys")}

        rp.channel.register("svc", "/op", handler)
    rep = ns.replica.Replicator(rps[0], rps[0].channel)
    dests, by_dest = rep._group_replicas(KEYS[:8], 2)
    responses = await rep.write(KEYS[:8], {"keys": KEYS[:8]}, "/op", opts=ns.replica.Options(n_value=2, w_value=2))
    return {"dests": dests, "by_dest": by_dest,
            "responses": sorted((r.destination, r.keys, r.body["from"]) for r in responses)}


def test_replicator_on_the_facade():
    both(scene_replicator_on_the_facade)


async def scene_adapter(ns):
    network, rps = await boot_cluster(ns, 3, app="adapter-test")
    service = "adapter-test"
    adapters = []
    for rp in rps:
        me = rp.who_am_i()

        async def handler(body, me=me):
            return {"handled_by": me, "user": body["user"]}

        adapters.append(ns.adapter.ServiceAdapter(
            rp, rp.channel, service, endpoints={"/user/get": (lambda b: b["user"], handler)},
            forward_options=ns.forward.Options(max_retries=0, timeout=1.0)))
    client = ns.LocalChannel(network, "ext:1")
    out = []
    for key in ["user-42"] + [f"user-{i}" for i in range(8)]:
        owner = rps[0].lookup(key)
        non_owner = next(rp for rp in rps if rp.who_am_i() != owner)
        res = await client.call(non_owner.who_am_i(), service, "/user/get", {"user": key}, timeout=2.0)
        assert res["handled_by"] == owner
        res2 = await adapters[0].call("/user/get", {"user": key})
        assert res2["handled_by"] == owner
        out.append((non_owner.who_am_i(), res, res2))

    for a in adapters:
        @ns.adapter.keyed(a, "/user/put", key=lambda body: body["user"])
        async def put(body, me=a.ringpop.who_am_i()):
            return {"put": body["user"], "by": me}

    for rp in rps:
        out.append(await client.call(rp.who_am_i(), service, "/user/put", {"user": "user-42"}, timeout=2.0))
    return out


def test_adapter_routes_by_key_with_loop_guard():
    both(scene_adapter)
