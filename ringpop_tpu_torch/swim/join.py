"""Cluster join / bootstrap path (parity: reference ``swim/join_sender.go``,
``swim/join_handler.go``, ``swim/join_delayer.go``).

Resolve hosts from the discover provider, prefer peers on *other* physical
hosts, join in parallel groups of ``(join_size - joined) * parallelism``
until ``join_size`` distinct nodes answered or ``max_join_duration`` passes,
with jittered-shifting-window exponential backoff between rounds.  The remote
handler validates app/self and returns its full membership + checksum.

Counterpart of ``ringpop_tpu/swim/join.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from typing import Optional

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch import util
from ringpop_tpu_torch.swim import events as ev
from ringpop_tpu_torch.swim.member import Change

JOIN_ENDPOINT = "/protocol/join"

# reference defaults (join_sender.go:38-52, join_delayer.go:33-36)
DEFAULT_JOIN_TIMEOUT = 1.0
DEFAULT_JOIN_SIZE = 3
DEFAULT_MAX_JOIN_DURATION = 120.0
DEFAULT_PARALLELISM_FACTOR = 2
DEFAULT_INITIAL_DELAY = 0.1
DEFAULT_MAX_DELAY = 60.0


@dataclass
class JoinRequest:
    app: str = ""
    source: str = ""
    incarnation: int = 0
    timeout: float = 0.0

    def to_wire(self) -> dict:
        # the reference's Timeout is a Go time.Duration, which encoding/json
        # marshals as INTEGER NANOSECONDS (join_sender.go:58-63) — keep that
        # unit on the wire; this codec holds float seconds internally
        return {
            "app": self.app,
            "source": self.source,
            "incarnationNumber": self.incarnation,
            "timeout": int(self.timeout * 1e9),
        }

    @classmethod
    def from_wire(cls, d: dict) -> "JoinRequest":
        return cls(
            app=d.get("app", ""),
            source=d.get("source", ""),
            incarnation=int(d.get("incarnationNumber", 0)),
            timeout=float(d.get("timeout", 0)) / 1e9,
        )


@dataclass
class JoinResponse:
    app: str = ""
    coordinator: str = ""
    membership: list[Change] = field(default_factory=list)
    checksum: int = 0

    def to_wire(self) -> dict:
        return {
            "app": self.app,
            "coordinator": self.coordinator,
            "membership": [c.to_wire() for c in self.membership],
            "membershipChecksum": self.checksum,
        }

    @classmethod
    def from_wire(cls, d: dict) -> "JoinResponse":
        return cls(
            app=d.get("app", ""),
            coordinator=d.get("coordinator", ""),
            membership=[Change.from_wire(c) for c in d.get("membership") or []],
            checksum=int(d.get("membershipChecksum", 0)),
        )


async def send_join_request(node, target: str, timeout: float) -> JoinResponse:
    """One join RPC (reused by bootstrap, reverse full sync and the healer —
    parity: ``join_sender.go:438-478`` sendJoinRequest)."""
    req = JoinRequest(
        app=node.app,
        source=node.address,
        incarnation=node.incarnation(),
        timeout=timeout,
    )
    body = await node.channel.call(
        target, node.service, JOIN_ENDPOINT, req.to_wire(), timeout=timeout
    )
    return JoinResponse.from_wire(body)


async def handle_join(node, body: dict, headers: dict) -> dict:
    """Validate app & non-self, answer with full membership
    (parity: ``join_handler.go:52-77``)."""
    req = JoinRequest.from_wire(body)
    if req.source == node.address:
        raise ValueError(
            f"A node tried joining a cluster by attempting to join itself. "
            f"The node, {req.source}, must join someone else."
        )
    if req.app != node.app:
        raise ValueError(
            f"A node tried joining a different app cluster. The expected app, "
            f"{node.app}, did not match the actual app, {req.app}"
        )
    node.emit(ev.JoinReceiveEvent(node.address, req.source))
    node.server_rate.mark()
    node.total_rate.mark()
    return JoinResponse(
        app=node.app,
        coordinator=node.address,
        membership=node.disseminator.membership_as_changes(),
        checksum=node.memberlist.checksum(),
    ).to_wire()


class ExponentialDelayer:
    """Jittered shifting-window exponential backoff
    (parity: ``join_delayer.go:144-191``): the jitter window for attempt N is
    [capped(N-1), capped(N)], so successive delays never shrink."""

    def __init__(
        self,
        initial: float = DEFAULT_INITIAL_DELAY,
        maximum: float = DEFAULT_MAX_DELAY,
        rng: Optional[random.Random] = None,
        sleeper=None,
    ):
        self.initial = initial
        self.max = maximum
        self.num_delays = 0
        self.next_delay_min = 0.0
        self.rng = rng or random.Random()
        self.sleeper = sleeper  # async callable; None -> asyncio.sleep

    async def delay(self) -> float:
        uncapped = self.initial * (2**self.num_delays)
        capped = min(self.max, uncapped)
        if capped == self.next_delay_min:
            jittered = capped
        else:
            jittered = self.rng.uniform(self.next_delay_min, capped)
        self.next_delay_min = capped
        self.num_delays += 1
        sleeper = self.sleeper or asyncio.sleep
        await sleeper(jittered)
        return jittered


class NullDelayer:
    async def delay(self) -> float:
        return 0.0


class JoinSender:
    """Drives the whole bootstrap join (parity: ``join_sender.go:281-435``)."""

    def __init__(
        self,
        node,
        timeout: float = 0.0,
        size: int = 0,
        max_join_duration: float = 0.0,
        parallelism_factor: int = 0,
        delayer=None,
        rng: Optional[random.Random] = None,
    ):
        self.node = node
        self.timeout = util.select_duration(timeout, DEFAULT_JOIN_TIMEOUT)
        self.size = util.select_int(size, DEFAULT_JOIN_SIZE)
        self.max_join_duration = util.select_duration(max_join_duration, DEFAULT_MAX_JOIN_DURATION)
        self.parallelism_factor = util.select_int(parallelism_factor, DEFAULT_PARALLELISM_FACTOR)
        self.delayer = delayer or ExponentialDelayer(rng=rng)
        self.rng = rng or random.Random()
        self.logger = logging_mod.logger("join").with_field("local", node.address)
        self.potential_nodes: list[str] = []

    def resolve_hosts(self) -> list[str]:
        """Provider hosts, ensuring self is present
        (parity: ``join_sender.go:128-138``), with hostname/IP sanity warning
        (``join_sender.go:171-185``)."""
        hosts = list(self.node.discover_provider.hosts())
        if self.node.address not in hosts:
            hosts.append(self.node.address)
        warning = util.check_hostname_ip_mismatch(self.node.address, hosts)
        if warning:
            self.logger.warn("%s", warning)
        return hosts

    def _partition(self, hosts: list[str]) -> tuple[list[str], list[str]]:
        """preferred = different physical host than us
        (parity: ``join_sender.go:207-233``)."""
        local_host = util.capture_host(self.node.address)
        preferred, non_preferred = [], []
        for hp in hosts:
            if hp == self.node.address:
                continue
            (non_preferred if util.capture_host(hp) == local_host else preferred).append(hp)
        return preferred, non_preferred

    def select_group(self, preferred: list[str], non_preferred: list[str], joined: set[str]) -> list[str]:
        """Draw the next round's targets, preferred-first
        (parity: ``join_sender.go:248-279``)."""
        group_size = (self.size - len(joined)) * self.parallelism_factor
        group: list[str] = []
        while len(group) < group_size and (preferred or non_preferred):
            pool = preferred if preferred else non_preferred
            candidate = util.take_node(pool, -1, self.rng)
            if candidate is None or candidate in joined:
                continue
            group.append(candidate)
        return group

    async def join_group(self, group: list[str]) -> tuple[list[str], list[Exception]]:
        """Join each target concurrently
        (parity: ``join_sender.go:364-435``)."""
        results = await asyncio.gather(
            *(send_join_request(self.node, target, self.timeout) for target in group),
            return_exceptions=True,
        )
        joined, errors = [], []
        for target, res in zip(group, results):
            if isinstance(res, BaseException):
                errors.append(res)
                continue
            self.node.memberlist.add_join_list(res.membership)
            joined.append(target)
        return joined, errors

    async def join_cluster(self) -> list[str]:
        """Rounds until join_size distinct coordinators answered or the
        duration cap passes (parity: ``join_sender.go:281-359``)."""
        hosts = self.resolve_hosts()
        self.potential_nodes = [h for h in hosts if h != self.node.address]

        if util.single_node_cluster(self.node.address, hosts):
            self.logger.info("got a single node cluster to join")
            return []

        preferred, non_preferred = self._partition(hosts)
        joined: set[str] = set()
        start = self.node.clock.now()
        num_failed_rounds = 0

        while len(joined) < self.size:
            if self.node.clock.now() - start > self.max_join_duration:
                msg = f"join duration {self.max_join_duration}s exceeded"
                self.node.emit(ev.JoinFailedEvent(reason="timeout", error=msg))
                raise JoinTimeoutError(msg)

            group = self.select_group(preferred, non_preferred, joined)
            if not group:
                # every candidate tried: successful if anyone answered,
                # otherwise retry the full candidate set after a delay
                if joined:
                    break
                preferred, non_preferred = self._partition(hosts)
                num_failed_rounds += 1
                self.node.emit(ev.JoinTriesUpdateEvent(num_failed_rounds))
                await self.delayer.delay()
                continue

            round_joined, errs = await self.join_group(group)
            joined.update(round_joined)
            if not round_joined:
                num_failed_rounds += 1
                self.node.emit(ev.JoinTriesUpdateEvent(num_failed_rounds))
                await self.delayer.delay()

        duration = self.node.clock.now() - start
        self.node.emit(
            ev.JoinCompleteEvent(duration=duration, num_joined=len(joined), joined=sorted(joined))
        )
        return sorted(joined)


class JoinTimeoutError(Exception):
    pass


async def send_join(node, **opts) -> list[str]:
    """(parity: ``join_sender.go:480-486`` sendJoin)"""
    return await JoinSender(node, **opts).join_cluster()
