"""Indirect probe path (parity: reference ``swim/ping_request_sender.go`` +
``swim/ping_request_handler.go``).

On direct-ping failure the prober asks ``k`` random pingable peers (excluding
the target) to ping the target on its behalf; any Ok answer proves the target
reachable, all-errors is inconclusive, reached-but-not-ok drives MakeSuspect
back in the node (``swim/node.go:494-510``).

Counterpart of ``ringpop_tpu/swim/ping_request.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from ringpop_tpu_torch.swim import events as ev
from ringpop_tpu_torch.swim.member import Change
from ringpop_tpu_torch.swim.ping import send_ping

PING_REQ_ENDPOINT = "/protocol/ping-req"


@dataclass
class PingRequest:
    source: str = ""
    source_incarnation: int = 0
    target: str = ""
    checksum: int = 0
    changes: list[Change] = field(default_factory=list)

    def to_wire(self) -> dict:
        return {
            "source": self.source,
            "sourceIncarnationNumber": self.source_incarnation,
            "target": self.target,
            "checksum": self.checksum,
            "changes": [c.to_wire() for c in self.changes],
        }

    @classmethod
    def from_wire(cls, d: dict) -> "PingRequest":
        return cls(
            source=d.get("source", ""),
            source_incarnation=int(d.get("sourceIncarnationNumber", 0)),
            target=d.get("target", ""),
            checksum=int(d.get("checksum", 0)),
            changes=[Change.from_wire(c) for c in d.get("changes") or []],
        )


@dataclass
class PingResponse:
    ok: bool = False
    target: str = ""
    changes: list[Change] = field(default_factory=list)

    def to_wire(self) -> dict:
        return {
            "pingStatus": self.ok,
            "target": self.target,
            "changes": [c.to_wire() for c in self.changes],
        }

    @classmethod
    def from_wire(cls, d: dict) -> "PingResponse":
        return cls(
            ok=bool(d.get("pingStatus")),
            target=d.get("target", ""),
            changes=[Change.from_wire(c) for c in d.get("changes") or []],
        )


async def _send_one_ping_request(node, peer: str, target: str, timeout: float) -> PingResponse:
    """One ping-req to one peer (parity: ``ping_request_sender.go:65-115``).
    Note the reference bumps piggyback counters on *error* here (the inverse
    of the ping path) — mirrored for parity."""
    changes, bump = node.disseminator.issue_as_sender()
    req = PingRequest(
        source=node.address,
        source_incarnation=node.incarnation(),
        target=target,
        checksum=node.memberlist.checksum(),
        changes=changes,
    )
    try:
        res_body = await node.channel.call(
            peer, node.service, PING_REQ_ENDPOINT, req.to_wire(), timeout=timeout
        )
    except Exception:
        bump()
        raise
    res = PingResponse.from_wire(res_body)
    node.memberlist.update(res.changes)
    return res


async def indirect_ping(
    node, target: str, amount: int, timeout: float
) -> tuple[bool, list[Exception]]:
    """Fan out ping-reqs; short-circuit on first Ok
    (parity: ``ping_request_sender.go:120-208``)."""
    peers = node.memberlist.random_pingable_members(amount, {target})
    peer_addresses = [p.address for p in peers]
    node.emit(ev.PingRequestsSendEvent(node.address, target, peer_addresses))

    if not peers:
        return False, []

    errs: list[Exception] = []
    reached = False
    tasks = {
        asyncio.ensure_future(_send_one_ping_request(node, p.address, target, timeout)): p.address
        for p in peers
    }
    pending = set(tasks)
    start = node.clock.now()
    try:
        while pending:
            done, pending = await asyncio.wait(pending, return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                peer = tasks[t]
                err = t.exception()
                if err is not None:
                    node.emit(
                        ev.PingRequestSendErrorEvent(node.address, target, peer_addresses, peer)
                    )
                    errs.append(err)
                    continue
                res = t.result()
                node.emit(
                    ev.PingRequestsSendCompleteEvent(
                        node.address, target, peer_addresses, peer, node.clock.now() - start
                    )
                )
                if res.ok:
                    reached = True
            if reached:
                break
    finally:
        for t in pending:
            t.cancel()
    return reached, errs


async def handle_ping_request(node, body: dict, headers: dict) -> dict:
    """Peer-side: ping the target for the prober
    (parity: ``ping_request_handler.go:32-76``)."""
    if not node.ready():
        node.emit(ev.RequestBeforeReadyEvent(PING_REQ_ENDPOINT))
        raise node.NotReadyError()

    req = PingRequest.from_wire(body)
    node.emit(
        ev.PingRequestReceiveEvent(node.address, req.source, req.target, req.changes)
    )
    node.server_rate.mark()
    node.total_rate.mark()
    node.memberlist.update(req.changes)

    start = node.clock.now()
    ping_ok = False
    try:
        res = await send_ping(node, req.target, node.ping_timeout)
        ping_ok = True
        node.emit(
            ev.PingRequestPingEvent(
                node.address, req.source, req.target, node.clock.now() - start
            )
        )
        node.memberlist.update(res.changes)
    except Exception:
        pass

    changes, _ = node.disseminator.issue_as_receiver(
        req.source, req.source_incarnation, req.checksum
    )  # full sync deliberately ignored on this path (ping_request_handler.go:70)

    return PingResponse(ok=ping_ok, target=req.target, changes=changes).to_wire()
