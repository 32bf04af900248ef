"""The port's SWIM wire (``ringpop_tpu_torch/swim``) against the golden files
the JAX package's host plane was frozen to, on the CPU.

* The four scripted conversations of ``tests/capture_wire_transcripts.py``
  (a piggybacked ping, a checksum-mismatch full sync with its reverse full
  sync, a join round, a heal that reincarnates before it merges), replayed
  with the port's ``Node`` over a recording ``LocalChannel``: every frame —
  caller, peer, endpoint, request and response body — equals
  ``tests/golden/wire_transcripts.json`` (read only) and the JAX package's
  live replay, with the same JSON key order.
* ``tests/golden/wire_corpus.json``: every ``Change`` decodes to its fields
  and re-encodes to its body with the JAX package's key order; the ping,
  ping-req and join bodies round-trip; the memberlist's canonical checksum
  strings and their farm32; the golden ping and join fed to the port's live
  handlers answer as the JAX package's do.
"""

from __future__ import annotations

import asyncio
import json
from pathlib import Path

import pytest
import torch

from test_wire_golden import _StubNode
from torch_swim_harness import JAX, PORT, bootstrap_nodes, make_nodes, package

GOLDEN = Path(__file__).parent / "golden"
TRANSCRIPTS = json.loads((GOLDEN / "wire_transcripts.json").read_text())
CORPUS = json.loads((GOLDEN / "wire_corpus.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def recording_channel(ns):
    class RecordingChannel(ns.LocalChannel):
        """LocalChannel that logs every outbound RPC frame and its response."""

        def __init__(self, network, hostport, app, log):
            super().__init__(network, hostport, app=app)
            self._log = log

        async def call(self, peer, service, endpoint, body, headers=None, timeout=None):
            frame = {"caller": self.hostport, "peer": peer, "service": service, "endpoint": endpoint,
                     "request": body}
            self._log.append(frame)
            try:
                res = await super().call(peer, service, endpoint, body, headers, timeout)
            except Exception as e:
                frame["error"] = type(e).__name__
                raise
            frame["response"] = res
            return res

    return RecordingChannel


def make_recorded_node(ns, network, address, log, app="test", seed=0):
    ch = recording_channel(ns)(network, address, app, log)
    opts = ns.NodeOptions(clock=ns.MockClock(start=1_000_000.0), seed=seed,
                          state_timeouts=ns.StateTimeouts(suspect=5.0))
    return ns.Node(app, address, ch, opts)


async def _boot(ns, nodes, hosts=None):
    hosts = hosts or [n.address for n in nodes]

    async def one(n):
        await n.bootstrap(ns.BootstrapOptions(discover_provider=hosts, join_timeout=0.5))
        n.gossip.stop()
        n.healer.stop()

    await asyncio.gather(*(one(n) for n in nodes))


async def _drain():
    for _ in range(6):
        await asyncio.sleep(0)


async def scene_ping_piggyback(ns):
    log: list = []
    net = ns.LocalNetwork()
    nodes = [make_recorded_node(ns, net, f"127.0.0.1:{3000 + i}", log, seed=50 + i) for i in range(3)]
    await _boot(ns, nodes)
    log.clear()
    a, b, c = nodes
    a.clock.advance(0.001)
    a.memberlist.make_suspect(c.address, a.memberlist.member(c.address).incarnation)
    await ns.send_ping(a, b.address, timeout=1.0)
    await _drain()
    for n in nodes:
        n.destroy()
    return log


async def scene_full_sync_reverse(ns):
    log: list = []
    net = ns.LocalNetwork()
    nodes = [make_recorded_node(ns, net, f"127.0.0.1:{3100 + i}", log, seed=60 + i) for i in range(2)]
    await _boot(ns, nodes)
    a, b = nodes
    a.disseminator.clear_changes()
    b.disseminator.clear_changes()
    b.memberlist.add_join_list([ns.Change(address="127.0.0.1:3999", incarnation=1_000_000_500,
                                          status=ns.state_id("alive"), source=b.address,
                                          source_incarnation=b.incarnation(), timestamp=1_000_000_500)])
    log.clear()
    await ns.send_ping(a, b.address, timeout=1.0)
    await _drain()
    for n in nodes:
        n.destroy()
    return log


async def scene_join_round(ns):
    log: list = []
    net = ns.LocalNetwork()
    ab = [make_recorded_node(ns, net, f"127.0.0.1:{3200 + i}", log, seed=70 + i) for i in range(2)]
    await _boot(ns, ab)
    joiner = make_recorded_node(ns, net, "127.0.0.1:3210", log, seed=77)
    log.clear()
    await _boot(ns, [joiner], hosts=[n.address for n in ab] + [joiner.address])
    await _drain()
    for n in ab + [joiner]:
        n.destroy()
    return log


async def scene_heal_reincarnate(ns):
    log: list = []
    net = ns.LocalNetwork()
    left = [make_recorded_node(ns, net, f"127.0.0.1:{3300 + i}", log, seed=80 + i) for i in range(2)]
    right = [make_recorded_node(ns, net, f"127.0.0.1:{3310 + i}", log, seed=90 + i) for i in range(2)]
    await _boot(ns, left)
    await _boot(ns, right)
    for side, other in ((left, right), (right, left)):
        for n in side:
            n.clock.advance(0.001)
            for m in other:
                n.memberlist.make_faulty(m.address, 1_000_000_000)
            n.disseminator.clear_changes()
    log.clear()
    await ns.heal.attempt_heal(left[0], right[0].address)
    await _drain()
    for n in left + right:
        n.destroy()
    return log


SCENES = {
    "ping_piggyback": scene_ping_piggyback,
    "full_sync_reverse": scene_full_sync_reverse,
    "join_round": scene_join_round,
    "heal_reincarnate": scene_heal_reincarnate,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_conversation_replays_frame_for_frame(name):
    got = asyncio.run(SCENES[name](package(PORT)))
    want = TRANSCRIPTS[name]
    assert [f["endpoint"] for f in got] == [f["endpoint"] for f in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"{name}: frame {i} ({w['endpoint']}) drifted"
    assert len(got) == len(want)
    # the frames' bytes as the channel's JSON encoder writes them: key order too
    live = asyncio.run(SCENES[name](package(JAX)))
    assert json.dumps(got) == json.dumps(live)


# -- the wire corpus ------------------------------------------------------


@pytest.mark.parametrize("case", CORPUS["changes"], ids=lambda c: c["name"])
def test_change_codec_matches_the_corpus(case):
    port, jax = package(PORT), package(JAX)
    c = port.Change.from_wire(case["wire"])
    want = case["decoded"]
    assert (c.address, c.incarnation, c.status, c.source, c.source_incarnation, c.timestamp) == (
        want["address"], want["incarnation"], want["status"], want["source"], want["source_incarnation"],
        want["timestamp"])
    assert c.to_wire() == case["wire"]
    assert json.dumps(c.to_wire()) == json.dumps(jax.Change.from_wire(case["wire"]).to_wire())
    d = case["decoded"]
    fields = dict(address=d["address"], incarnation=d["incarnation"], status=d["status"], source=d["source"],
                  source_incarnation=d["source_incarnation"], timestamp=d["timestamp"])
    assert json.dumps(port.Change(**fields).to_wire()) == json.dumps(jax.Change(**fields).to_wire())
    member = port.member_to_change(port.Member(d["address"], d["status"] if d["status"] >= 0 else 0,
                                               d["incarnation"]), "src:1", 7, ts=9)
    jmember = jax.member_to_change(jax.Member(d["address"], d["status"] if d["status"] >= 0 else 0,
                                              d["incarnation"]), "src:1", 7, ts=9)
    assert json.dumps(member.to_wire()) == json.dumps(jmember.to_wire())


def test_message_bodies_round_trip():
    from ringpop_tpu_torch.swim.join import JoinRequest, JoinResponse
    from ringpop_tpu_torch.swim.ping import Ping
    from ringpop_tpu_torch.swim.ping_request import PingRequest, PingResponse

    for cls, key in ((Ping, "ping_request"), (PingRequest, "ping_req_request"),
                     (PingResponse, "ping_req_response"), (JoinRequest, "join_request"),
                     (JoinResponse, "join_response")):
        wire = CORPUS[key]["wire"]
        assert cls.from_wire(wire).to_wire() == wire, key
    assert JoinRequest.from_wire(CORPUS["join_request"]["wire"]).timeout == \
        CORPUS["join_request"]["decoded_timeout_seconds"]
    res = JoinResponse.from_wire(CORPUS["join_response"]["wire"])
    assert res.membership[1].status == package(PORT).state_id("tombstone")


@pytest.mark.parametrize("case", CORPUS["checksum_strings"], ids=lambda c: c["name"])
def test_checksum_string_matches_the_corpus(case):
    from ringpop_tpu_torch.hashing import fingerprint32
    from ringpop_tpu_torch.swim.memberlist import Memberlist

    ns = package(PORT)
    ml = Memberlist(_StubNode())
    for m in case["members"]:
        if m["status"] == "tombstone":
            # first-seen tombstones are refused: arrive as faulty, then lift via the shim
            ml.update([ns.Change(m["address"], m["incarnation"], ns.state_id("faulty"))])
            ml.update([ns.Change.from_wire({"address": m["address"], "incarnationNumber": m["incarnation"],
                                            "status": "faulty", "tombstone": True})])
        else:
            ml.update([ns.Change(m["address"], m["incarnation"], ns.state_id(m["status"]))])
    assert ml.gen_checksum_string() == case["canonical"]
    assert ml.compute_checksum() == case["farm32"]
    assert fingerprint32(case["canonical"]) == case["farm32"]


async def _handler_replies(ns):
    out = {}
    nodes = make_nodes(ns, 2, app="testapp")
    await bootstrap_nodes(ns, nodes)
    ping, join = ns.module("swim.ping"), ns.module("swim.join")
    out["ping"] = await ping.handle_ping(nodes[0], CORPUS["ping_request"]["wire"], {})
    m = nodes[0].memberlist.member("10.0.0.2:3000")
    out["applied"] = (m.address, m.status, m.incarnation)
    out["join"] = await join.handle_join(nodes[0], CORPUS["join_request"]["wire"], {})
    others = make_nodes(ns, 2, app="otherapp")
    await bootstrap_nodes(ns, others)
    with pytest.raises(ValueError, match="different app") as e:
        await join.handle_join(others[0], CORPUS["join_request"]["wire"], {})
    out["refusal"] = str(e.value)
    for nd in nodes + others:
        nd.destroy()
    return out


def test_golden_bodies_replay_through_live_handlers():
    got = asyncio.run(_handler_replies(package(PORT)))
    want = asyncio.run(_handler_replies(package(JAX)))
    assert json.dumps(got) == json.dumps(want)
    assert set(got["ping"]) == {"changes", "checksum", "source", "sourceIncarnationNumber"}
    assert set(got["join"]) == {"app", "coordinator", "membership", "membershipChecksum"}
    assert got["applied"][2] == CORPUS["ping_request"]["wire"]["changes"][0]["incarnationNumber"]
