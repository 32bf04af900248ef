"""Direct probe path (parity: reference ``swim/ping_sender.go`` +
``swim/ping_handler.go``).

Request/response both carry ``{changes, checksum, source,
sourceIncarnationNumber}`` (``ping_sender.go:35-40``); the handler applies
piggybacked changes, answers with its own changes or a full sync, and may
kick off a reverse full sync (``ping_handler.go:25-58``).

Counterpart of ``ringpop_tpu/swim/ping.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ringpop_tpu_torch.swim import events as ev
from ringpop_tpu_torch.swim.member import Change

PING_ENDPOINT = "/protocol/ping"
REVERSE_FULL_SYNC_TIMEOUT = 1.0  # ping_handler.go:55 (time.Second)


@dataclass
class Ping:
    changes: list[Change] = field(default_factory=list)
    checksum: int = 0
    source: str = ""
    source_incarnation: int = 0

    def to_wire(self) -> dict:
        return {
            "changes": [c.to_wire() for c in self.changes],
            "checksum": self.checksum,
            "source": self.source,
            "sourceIncarnationNumber": self.source_incarnation,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "Ping":
        return cls(
            changes=[Change.from_wire(c) for c in d.get("changes") or []],
            checksum=int(d.get("checksum", 0)),
            source=d.get("source", ""),
            source_incarnation=int(d.get("sourceIncarnationNumber", 0)),
        )


async def send_ping(node, target: str, timeout: float) -> Ping:
    """Send a direct ping; piggyback counters bump only on success
    (parity: ``ping_sender.go:43-120``)."""
    changes, bump = node.disseminator.issue_as_sender()
    return await _send(node, target, changes, timeout, bump)


async def send_ping_with_changes(node, target: str, changes: list[Change], timeout: float) -> Ping:
    """Ping carrying an explicit change list — used by the partition healer
    (parity: ``ping_sender.go`` sendPingWithChanges)."""
    return await _send(node, target, changes, timeout, None)


async def _send(node, target, changes, timeout, bump) -> Ping:
    req = Ping(
        changes=changes,
        checksum=node.memberlist.checksum(),
        source=node.address,
        source_incarnation=node.incarnation(),
    )
    node.emit(ev.PingSendEvent(node.address, target, changes))
    start = node.clock.now()
    res_body = await node.channel.call(
        target, node.service, PING_ENDPOINT, req.to_wire(), timeout=timeout
    )
    node.emit(
        ev.PingSendCompleteEvent(node.address, target, changes, node.clock.now() - start)
    )
    if bump is not None:
        bump()
    return Ping.from_wire(res_body)


async def handle_ping(node, body: dict, headers: dict) -> dict:
    """(parity: ``ping_handler.go:25-58``)"""
    if not node.ready():
        node.emit(ev.RequestBeforeReadyEvent(PING_ENDPOINT))
        raise node.NotReadyError()

    req = Ping.from_wire(body)
    node.emit(ev.PingReceiveEvent(node.address, req.source, req.changes))
    node.server_rate.mark()
    node.total_rate.mark()

    node.memberlist.update(req.changes)
    changes, full_sync = node.disseminator.issue_as_receiver(
        req.source, req.source_incarnation, req.checksum
    )

    res = Ping(
        changes=changes,
        checksum=node.memberlist.checksum(),
        source=node.address,
        source_incarnation=node.incarnation(),
    )
    if full_sync:
        node.disseminator.try_start_reverse_full_sync(req.source, REVERSE_FULL_SYNC_TIMEOUT)
    return res.to_wire()
