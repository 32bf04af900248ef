"""SWIM node — aggregates all sub-protocols (parity: reference
``swim/node.go``).

Lifecycle: ``Node(...)`` wires memberlist/disseminator/state-transitions/
gossip/healer/rollup and registers the ``/protocol/*`` handlers; ``bootstrap``
reincarnates self, joins the cluster and starts gossip + healing; one gossip
period pings the next member with indirect ping-req fallback and Suspect
declaration (``node.go:470-513``).

Counterpart of ``ringpop_tpu/swim/node.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, field
from typing import Optional

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch import util
from ringpop_tpu_torch.discovery import DiscoverProvider, as_provider
from ringpop_tpu_torch.events import EventEmitter
from ringpop_tpu_torch.swim import events as ev
from ringpop_tpu_torch.swim.disseminator import Disseminator, DEFAULT_P_FACTOR
from ringpop_tpu_torch.swim.gossip import Gossip, DEFAULT_MIN_PROTOCOL_PERIOD
from ringpop_tpu_torch.swim.heal import (
    DEFAULT_HEAL_BASE_PROBABILITY,
    DEFAULT_HEAL_PERIOD,
    DiscoverProviderHealer,
)
from ringpop_tpu_torch.swim.iter import MemberlistIter
from ringpop_tpu_torch.swim.join import send_join
from ringpop_tpu_torch.swim.member import Change
from ringpop_tpu_torch.swim.memberlist import Memberlist
from ringpop_tpu_torch.swim.ping import handle_ping, send_ping
from ringpop_tpu_torch.swim.ping_request import handle_ping_request, indirect_ping
from ringpop_tpu_torch.swim.rollup import UpdateRollup
from ringpop_tpu_torch.swim.state_transitions import StateTimeouts, StateTransitions
from ringpop_tpu_torch.swim.member import ALIVE, FAULTY, LEAVE, SUSPECT, TOMBSTONE
from ringpop_tpu_torch.util.clock import Clock, MockClock, drive_clock
from ringpop_tpu_torch.util.metrics import Meter

# reference defaults (swim/node.go:72-100)
DEFAULT_PING_TIMEOUT = 1.5
DEFAULT_PING_REQUEST_TIMEOUT = 5.0
DEFAULT_PING_REQUEST_SIZE = 3
DEFAULT_MAX_REVERSE_FULL_SYNC_JOBS = 5


class NotReadyError(Exception):
    """(parity: ``swim/node.go:41`` ErrNodeNotReady)"""

    def __str__(self) -> str:
        return "node is not ready to handle requests"


@dataclass
class NodeOptions:
    """(parity: ``swim/node.go:45-70`` Options; zero selects defaults)"""

    state_timeouts: StateTimeouts = field(default_factory=StateTimeouts)
    min_protocol_period: float = 0.0
    ping_timeout: float = 0.0
    ping_request_timeout: float = 0.0
    ping_request_size: int = 0
    max_reverse_full_sync_jobs: int = 0
    partition_heal_period: float = 0.0
    partition_heal_base_probability: float = 0.0
    p_factor: int = 0
    clock: Optional[Clock] = None
    seed: Optional[int] = None


@dataclass
class BootstrapOptions:
    """(parity: ``swim/node.go:350-373``)"""

    discover_provider: Optional[object] = None
    join_size: int = 0
    max_join_duration: float = 0.0
    parallelism_factor: int = 0
    join_timeout: float = 0.0


class Node:
    NotReadyError = NotReadyError

    def __init__(self, app: str, address: str, channel, options: Optional[NodeOptions] = None):
        opts = options or NodeOptions()
        self.app = app
        self.address = address
        self.channel = channel
        self.service = "ringpop"
        self.clock: Clock = opts.clock or Clock()
        rng_seed = opts.seed
        self._rng = random.Random(rng_seed)

        self.ping_timeout = util.select_duration(opts.ping_timeout, DEFAULT_PING_TIMEOUT)
        self.ping_request_timeout = util.select_duration(
            opts.ping_request_timeout, DEFAULT_PING_REQUEST_TIMEOUT
        )
        self.ping_request_size = util.select_int(opts.ping_request_size, DEFAULT_PING_REQUEST_SIZE)

        self.emitter = EventEmitter()
        self.logger = logging_mod.logger("node").with_field("local", address)

        self.client_rate = Meter(self.clock)
        self.server_rate = Meter(self.clock)
        self.total_rate = Meter(self.clock)

        self._ready = False
        self._stopped = False  # Go zero-value parity: a fresh node is not stopped
        self._destroyed = False
        self._pinging = False

        self.discover_provider: Optional[DiscoverProvider] = None

        self.memberlist = Memberlist(self, rng=random.Random(self._rng.random()))
        self.memberiter = MemberlistIter(self.memberlist, rng=random.Random(self._rng.random()))
        self.disseminator = Disseminator(
            self,
            p_factor=util.select_int(opts.p_factor, DEFAULT_P_FACTOR),
            max_reverse_full_sync_jobs=util.select_int(
                opts.max_reverse_full_sync_jobs, DEFAULT_MAX_REVERSE_FULL_SYNC_JOBS
            ),
        )
        self.state_transitions = StateTransitions(self, opts.state_timeouts)
        self.gossip = Gossip(
            self,
            util.select_duration(opts.min_protocol_period, DEFAULT_MIN_PROTOCOL_PERIOD),
            rng=random.Random(self._rng.random()),
        )
        self.rollup = UpdateRollup(self)
        self._clock_driver: Optional[asyncio.Task] = None
        self.healer = DiscoverProviderHealer(
            self,
            period=util.select_duration(opts.partition_heal_period, DEFAULT_HEAL_PERIOD),
            base_probability=util.select_float(
                opts.partition_heal_base_probability, DEFAULT_HEAL_BASE_PROBABILITY
            ),
            rng=random.Random(self._rng.random()),
        )
        self._register_handlers()

    # -- plumbing -----------------------------------------------------------

    def emit(self, event) -> None:
        self.emitter.emit(event)

    def register_listener(self, listener) -> None:
        self.emitter.register_listener(listener)

    def incarnation(self) -> int:
        """(parity: ``swim/node.go`` Incarnation)"""
        if self.memberlist.local is not None:
            return self.memberlist.local.incarnation
        return -1

    def _register_handlers(self) -> None:
        """(parity: ``swim/handlers.go:63-82``)"""
        from ringpop_tpu_torch.swim.join import handle_join
        from ringpop_tpu_torch.swim import handlers as admin

        self.channel.register(self.service, "/protocol/ping", lambda b, h: handle_ping(self, b, h))
        self.channel.register(
            self.service, "/protocol/ping-req", lambda b, h: handle_ping_request(self, b, h)
        )
        self.channel.register(self.service, "/protocol/join", lambda b, h: handle_join(self, b, h))
        admin.register_admin_handlers(self)

    # -- lifecycle (parity: node.go:281-341) --------------------------------

    def ready(self) -> bool:
        return self._ready

    def stopped(self) -> bool:
        return self._stopped

    def destroyed(self) -> bool:
        return self._destroyed

    def _start_clock_driver(self) -> None:
        # real clocks need an asyncio pump so transition timers actually
        # fire; mock clocks are driven by tests via advance()
        if isinstance(self.clock, MockClock):
            return
        if self._clock_driver is None or self._clock_driver.done():
            self._clock_driver = asyncio.ensure_future(drive_clock(self.clock))

    def _stop_clock_driver(self) -> None:
        if self._clock_driver is not None:
            self._clock_driver.cancel()
            self._clock_driver = None

    def start(self) -> None:
        self.gossip.start()
        self.state_transitions.enable()
        self._start_clock_driver()
        self._stopped = False

    def stop(self) -> None:
        self.gossip.stop()
        self.state_transitions.disable()
        self._stopped = True

    def destroy(self) -> None:
        self.stop()
        self.healer.stop()
        self.rollup.destroy()
        self._stop_clock_driver()
        self._ready = False
        self._destroyed = True

    async def bootstrap(self, opts: Optional[BootstrapOptions] = None) -> list[str]:
        """(parity: ``swim/node.go:377-416`` Bootstrap)"""
        opts = opts or BootstrapOptions()
        if opts.discover_provider is None:
            raise ValueError("a discover provider is required to bootstrap")
        self.discover_provider = as_provider(opts.discover_provider)

        self.memberlist.reincarnate()
        self._stopped = False
        joined = await send_join(
            self,
            timeout=opts.join_timeout,
            size=opts.join_size,
            max_join_duration=opts.max_join_duration,
            parallelism_factor=opts.parallelism_factor,
            rng=random.Random(self._rng.random()),
        )
        self.gossip.start()
        self.healer.start()
        self._start_clock_driver()
        self._ready = True
        return joined

    # -- change reactions (parity: node.go:424-447) -------------------------

    def handle_changes(self, changes: list[Change]) -> None:
        self.disseminator.adjust_max_propagations()
        for change in changes:
            self.disseminator.record_change(change)
            if change.status == ALIVE:
                self.state_transitions.cancel(change)
            elif change.status == SUSPECT:
                self.state_transitions.schedule_suspect_to_faulty(change)
            elif change.status == FAULTY:
                self.state_transitions.schedule_faulty_to_tombstone(change)
            elif change.status == LEAVE:
                self.state_transitions.cancel(change)
            elif change.status == TOMBSTONE:
                self.state_transitions.schedule_tombstone_to_evict(change)

    # -- gossip round (parity: node.go:470-513) -----------------------------

    async def ping_next_member(self) -> None:
        member = self.memberiter.next()
        if member is None:
            self.logger.warn("no pingable members")
            return
        if self._pinging:
            self.logger.warn("node already pinging")
            return
        self._pinging = True
        try:
            self.client_rate.mark()
            self.total_rate.mark()
            try:
                res = await send_ping(self, member.address, self.ping_timeout)
                self.memberlist.update(res.changes)
                return
            except Exception:
                pass

            target = member.address
            reached, errs = await indirect_ping(
                self, target, self.ping_request_size, self.ping_request_timeout
            )
            if len(errs) == self.ping_request_size:
                self.logger.warn("ping request inconclusive due to errors")
                return
            if not reached:
                self.logger.info("ping request target unreachable: %s", target)
                self.memberlist.make_suspect(member.address, member.incarnation)
                return
        finally:
            self._pinging = False

    # -- convenience queries ------------------------------------------------

    def get_reachable_members(self) -> list[str]:
        return self.memberlist.get_reachable_members()

    def count_reachable_members(self) -> int:
        return self.memberlist.count_reachable_members()

    def member_count(self) -> int:
        return self.memberlist.num_members()


def new_node(app: str, address: str, channel, options: Optional[NodeOptions] = None) -> Node:
    return Node(app, address, channel, options)
