"""Ringpop facade — the public API (parity: reference ``ringpop.go``).

Wires the SWIM node, the hash ring and the forwarder; keeps the lifecycle
state machine (created→initialized→ready→destroyed, ``ringpop.go:101-119``);
translates membership changes into ring add/removes
(``ringpop.go:550-563``); maps every event to stats under
``ringpop.<host_port>.<metric>`` (``ringpop.go:385-548``); and exposes
``lookup``/``handle_or_forward``/``forward`` for keyed request routing.

Counterpart of ``ringpop_tpu/ringpop.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import enum
import time as _time
from typing import Optional

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch import events as facade_ev
from ringpop_tpu_torch.errors import InvalidStateError, NotBootstrappedError
from ringpop_tpu_torch.events import EventEmitter
from ringpop_tpu_torch.forward import Forwarder, Options as ForwardOptions, has_forwarded_header
from ringpop_tpu_torch.forward import events as fwd_ev
from ringpop_tpu_torch.hashring import HashRing
from ringpop_tpu_torch.options import NoopStats, Options, default_identity_resolver
from ringpop_tpu_torch.swim import events as swim_ev
from ringpop_tpu_torch.swim.member import ALIVE, FAULTY, LEAVE, SUSPECT, TOMBSTONE, state_name
from ringpop_tpu_torch.swim.node import BootstrapOptions, Node, NodeOptions
from ringpop_tpu_torch.swim import stats as swim_stats


class State(enum.Enum):
    CREATED = 0
    INITIALIZED = 1
    READY = 2
    DESTROYED = 3


class Interface:
    """The facade API surface (parity: ``ringpop.go:48-63`` Interface)."""

    def destroy(self) -> None: ...

    def app(self) -> str: ...

    def who_am_i(self) -> str: ...

    def uptime(self) -> float: ...

    def register_listener(self, l) -> None: ...

    async def bootstrap(self, opts) -> list[str]: ...

    def checksum(self) -> int: ...

    def lookup(self, key: str) -> str: ...

    def lookup_n(self, key: str, n: int) -> list[str]: ...

    def get_reachable_members(self) -> list[str]: ...

    def count_reachable_members(self) -> int: ...


class Ringpop(Interface):
    def __init__(self, app: str, channel, options: Optional[Options] = None):
        if channel is None:
            raise ValueError("channel is required (options.go:113 Channel)")
        self._app = app
        self.channel = channel
        self.options = options or Options()
        self.logger = logging_mod.logger("ringpop")
        self.stats = self.options.stats_reporter or NoopStats()
        self.emitter = EventEmitter()
        self._state = State.CREATED
        self._start_time: Optional[float] = None
        self._stat_key_cache: dict[str, str] = {}
        self._stat_hostport: str = ""
        self._stat_timers: list = []

        self.node: Optional[Node] = None
        self.ring: Optional[HashRing] = None
        self.forwarder: Optional[Forwarder] = None
        self.whoami: Optional[str] = None

    # -- lifecycle (parity: ringpop.go:101-119, 153-186) --------------------

    @property
    def state(self) -> State:
        return self._state

    def _init(self) -> None:
        if self.options.identity:
            address = self.options.identity
        elif self.options.identity_resolver is not None:
            address = self.options.identity_resolver()
        else:
            address = default_identity_resolver(self.channel)
        self.whoami = address
        self._stat_hostport = address.replace(":", "_").replace(".", "_")

        node_opts = NodeOptions(
            state_timeouts=self.options.resolved_state_timeouts(),
            clock=self.options.clock,
            seed=self.options.seed,
        )
        self.node = Node(self._app, address, self.channel, node_opts)
        self.ring = HashRing(
            hashfunc=self.options.hashfunc, replica_points=self.options.replica_points
        )
        self.forwarder = Forwarder(self, self.channel)

        # the facade listens to everything and is the glue between layers
        # (ringpop.go:170-180)
        self.node.register_listener(self)
        self.ring.register_listener(self)
        self.forwarder.register_listener(self)

        self._register_admin_handlers()
        self._start_timers()
        self._state = State.INITIALIZED

    def _start_timers(self) -> None:
        """Periodic membership/ring checksum gauges
        (parity: ``ringpop.go:190-221`` startTimers)."""
        clock = self.node.clock

        def emit_membership_checksum():
            self.stat_gauge("membership.checksum-periodic", self.node.memberlist.checksum())
            self._stat_timers.append(
                clock.after(self.options.membership_checksum_stat_period, emit_membership_checksum)
            )

        def emit_ring_checksum():
            self.stat_gauge("ring.checksum-periodic", self.ring.checksum())
            self._stat_timers.append(
                clock.after(self.options.ring_checksum_stat_period, emit_ring_checksum)
            )

        if self.options.membership_checksum_stat_period > 0:
            self._stat_timers.append(
                clock.after(self.options.membership_checksum_stat_period, emit_membership_checksum)
            )
        if self.options.ring_checksum_stat_period > 0:
            self._stat_timers.append(
                clock.after(self.options.ring_checksum_stat_period, emit_ring_checksum)
            )

    async def bootstrap(self, opts: Optional[BootstrapOptions] = None, **kw) -> list[str]:
        """(parity: ``ringpop.go:348-377`` Bootstrap)"""
        if self._state == State.DESTROYED:
            raise InvalidStateError("destroyed ringpop cannot bootstrap")
        if self._state == State.CREATED:
            self._init()
        if opts is None:
            opts = BootstrapOptions(**kw)
        joined = await self.node.bootstrap(opts)
        self._state = State.READY
        self._start_time = _time.time()
        self.emitter.emit(facade_ev.Ready())
        return joined

    def ready(self) -> bool:
        return self._state == State.READY

    def destroy(self) -> None:
        if self.node is not None:
            self.node.destroy()
        for t in self._stat_timers:
            t.stop()
        self._state = State.DESTROYED
        self.emitter.emit(facade_ev.Destroyed())

    # -- identity / basics --------------------------------------------------

    def app(self) -> str:
        return self._app

    def who_am_i(self) -> str:
        if self.whoami is None:
            raise NotBootstrappedError()
        return self.whoami

    def uptime(self) -> float:
        if not self.ready() or self._start_time is None:
            raise NotBootstrappedError()
        return _time.time() - self._start_time

    def checksum(self) -> int:
        if not self.ready():
            raise NotBootstrappedError()
        return self.ring.checksum()

    def register_listener(self, listener) -> None:
        self.emitter.register_listener(listener)

    def get_reachable_members(self) -> list[str]:
        if not self.ready():
            raise NotBootstrappedError()
        return self.node.get_reachable_members()

    def count_reachable_members(self) -> int:
        if not self.ready():
            raise NotBootstrappedError()
        return self.node.count_reachable_members()

    # -- lookup (parity: ringpop.go:582-625) --------------------------------

    def lookup(self, key: str) -> str:
        if not self.ready():
            raise NotBootstrappedError()
        t0 = _time.perf_counter()
        dest = self.ring.lookup(key)
        duration = _time.perf_counter() - t0
        self.stat_timing("lookup", duration)
        self.emitter.emit(facade_ev.LookupEvent(key, duration))
        if dest is None:
            raise NotBootstrappedError()
        return dest

    def lookup_n(self, key: str, n: int) -> list[str]:
        if not self.ready():
            raise NotBootstrappedError()
        t0 = _time.perf_counter()
        dests = self.ring.lookup_n(key, n)
        duration = _time.perf_counter() - t0
        self.stat_timing("lookupn", duration)
        self.emitter.emit(facade_ev.LookupNEvent(key, n, duration))
        return dests

    def lookup_n_batch(self, keys: list[str], n: int) -> list[list[str]]:
        """Preference lists for many keys in one batched ring walk — the
        batched path the replicator's multi-key fan-out uses."""
        if not self.ready():
            raise NotBootstrappedError()
        t0 = _time.perf_counter()
        rows = self.ring.lookup_n_batch(keys, n)
        duration = _time.perf_counter() - t0
        # distinct stat: this sample covers the whole batch — mixing it into
        # the per-key "lookupn" timer would corrupt that distribution
        self.stat_timing("lookupn-batch", duration)
        self.emitter.emit(facade_ev.LookupNBatchEvent(len(keys), n, duration))
        return rows

    # -- keyed routing (parity: ringpop.go:687-723) -------------------------

    async def handle_or_forward(
        self,
        key: str,
        body: dict,
        service: str,
        endpoint: str,
        options: Optional[ForwardOptions] = None,
        headers: Optional[dict] = None,
    ) -> tuple[bool, Optional[dict]]:
        """Returns (True, None) when the local node owns ``key`` — the caller
        handles the request — else forwards and returns (False, response)
        (parity: ``ringpop.go:687-713`` HandleOrForward)."""
        if not self.ready():
            raise NotBootstrappedError()
        if has_forwarded_header(headers):
            return True, None  # loop guard: already forwarded once
        dest = self.lookup(key)
        if dest == self.who_am_i():
            return True, None
        res = await self.forward(dest, [key], body, service, endpoint, options)
        return False, res

    async def forward(
        self,
        dest: str,
        keys: list[str],
        body: dict,
        service: str,
        endpoint: str,
        options: Optional[ForwardOptions] = None,
    ) -> dict:
        """(parity: ``ringpop.go:715-723`` Forward)"""
        if self.forwarder is None:
            raise NotBootstrappedError()
        return await self.forwarder.forward_request(body, dest, service, endpoint, keys, options)

    # -- stats plumbing (parity: ringpop.go:175-177, 665-675) ---------------

    def get_stat_key(self, key: str) -> str:
        cached = self._stat_key_cache.get(key)
        if cached is None:
            cached = f"ringpop.{self._stat_hostport}.{key}"
            self._stat_key_cache[key] = cached
        return cached

    def stat_incr(self, key: str, value: int = 1) -> None:
        self.stats.incr(self.get_stat_key(key), value)

    def stat_gauge(self, key: str, value: float) -> None:
        self.stats.gauge(self.get_stat_key(key), value)

    def stat_timing(self, key: str, seconds: float) -> None:
        self.stats.timing(self.get_stat_key(key), seconds)

    # -- event -> stats + ring sync (parity: ringpop.go:385-563) ------------

    def handle_event(self, event) -> None:
        # dict dispatch on the exact event type (the events are flat
        # dataclasses, never subclassed) — the reference's 60-stat switch
        # (ringpop.go:385-548) as one table lookup instead of ~40 isinstance
        # probes per event; this runs 3-4x per forwarded request
        fn = _EVENT_STATS.get(type(event))
        if fn is not None:
            fn(self, event)

        # relay everything to facade listeners (async dispatch in the
        # reference, ringpop.go:297-301; synchronous relay here)
        self.emitter.emit(event)

    def _on_changes_applied(self, e) -> None:
        self.stat_incr("changes.apply", 0)  # applied count below
        self.stat_gauge("num-members", e.num_members)
        self.stat_incr("membership-set.alive", 0)
        for change in e.changes:
            self.stat_incr(f"membership-update.{state_name(change.status)}")
        self.stat_gauge("checksum", e.new_checksum)
        self.stat_incr("membership.checksum-computed")
        self._handle_changes(e.changes)

    def _on_join_complete(self, e) -> None:
        self.stat_incr("join.complete")
        self.stat_timing("join", e.duration)
        self.stat_incr("join.succeeded")

    def _on_checksum_computed(self, e) -> None:
        self.stat_timing("compute-checksum", e.duration)
        self.stat_gauge("checksum", e.checksum)

    def _on_ring_changed(self, e) -> None:
        self.stat_incr("ring.changed")
        for _ in e.servers_added:
            self.stat_incr("ring.server-added")
        for _ in e.servers_removed:
            self.stat_incr("ring.server-removed")

    def _handle_changes(self, changes) -> None:
        """Membership → ring sync (parity: ``ringpop.go:550-563``)."""
        to_add, to_remove = [], []
        for change in changes:
            if change.status in (ALIVE, SUSPECT):
                to_add.append(change.address)
            elif change.status in (FAULTY, LEAVE, TOMBSTONE):
                to_remove.append(change.address)
        if to_add or to_remove:
            self.ring.add_remove_servers(to_add, to_remove)

    # -- Forwarder Sender protocol ------------------------------------------

    # who_am_i and lookup double as the forward.Sender interface
    # (forward/forwarder.go:39-45)

    # -- admin endpoints (parity: handlers.go:33-67, stats_handler.go) ------

    def _register_admin_handlers(self) -> None:
        async def health(body, headers):
            return {"ok": True}

        async def admin_stats(body, headers):
            return self._collect_stats()

        async def admin_lookup(body, headers):
            key = (body or {}).get("key", "")
            return {"dest": self.ring.lookup(key)}

        self.channel.register("ringpop", "/health", health)
        self.channel.register("ringpop", "/admin/stats", admin_stats)
        self.channel.register("ringpop", "/admin/lookup", admin_lookup)

    def _collect_stats(self) -> dict:
        """(parity: ``stats_handler.go:32-63`` handleStats)"""
        import resource

        usage = resource.getrusage(resource.RUSAGE_SELF)
        return {
            "hooks": None,
            "membership": swim_stats.member_stats(self.node),
            "process": {
                "maxrss_kb": usage.ru_maxrss,
                "utime_s": usage.ru_utime,
                "stime_s": usage.ru_stime,
            },
            "protocol": swim_stats.protocol_stats(self.node),
            "ring": {
                "servers": self.ring.servers(),
                "checksum": self.ring.checksum(),
            },
            "state": self._state.name.lower(),
            "uptime": self.uptime() if self.ready() else 0,
        }


def new(app: str, channel, options: Optional[Options] = None, **kw) -> Ringpop:
    """(parity: ``ringpop.go:122`` New)"""
    if options is None and kw:
        options = Options(**kw)
    return Ringpop(app, channel, options)


# event type -> stats action for Ringpop.handle_event (parity with the
# reference's per-event switch, ringpop.go:385-548)
_EVENT_STATS = {
    swim_ev.MemberlistChangesReceivedEvent: lambda rp, e: rp.stat_incr("changes.apply", len(e.changes)),
    swim_ev.MemberlistChangesAppliedEvent: Ringpop._on_changes_applied,
    swim_ev.FullSyncEvent: lambda rp, e: rp.stat_incr("full-sync"),
    swim_ev.StartReverseFullSyncEvent: lambda rp, e: rp.stat_incr("full-sync.reverse"),
    swim_ev.OmitReverseFullSyncEvent: lambda rp, e: rp.stat_incr("full-sync.reverse.omitted"),
    swim_ev.MaxPAdjustedEvent: lambda rp, e: rp.stat_gauge("max-piggyback", e.new_pcount),
    swim_ev.JoinReceiveEvent: lambda rp, e: rp.stat_incr("join.recv"),
    swim_ev.JoinCompleteEvent: Ringpop._on_join_complete,
    swim_ev.JoinFailedEvent: lambda rp, e: rp.stat_incr("join.failed"),
    swim_ev.JoinTriesUpdateEvent: lambda rp, e: rp.stat_gauge("join.retries", e.retries),
    swim_ev.PingSendEvent: lambda rp, e: rp.stat_incr("ping.send"),
    swim_ev.PingSendCompleteEvent: lambda rp, e: rp.stat_timing("ping", e.duration),
    swim_ev.PingReceiveEvent: lambda rp, e: rp.stat_incr("ping.recv"),
    swim_ev.PingRequestsSendEvent: lambda rp, e: rp.stat_incr("ping-req.send", len(e.peers)),
    swim_ev.PingRequestsSendCompleteEvent: lambda rp, e: rp.stat_timing("ping-req", e.duration),
    swim_ev.PingRequestSendErrorEvent: lambda rp, e: rp.stat_incr("ping-req.err"),
    swim_ev.PingRequestReceiveEvent: lambda rp, e: rp.stat_incr("ping-req.recv"),
    swim_ev.PingRequestPingEvent: lambda rp, e: rp.stat_timing("ping-req.ping", e.duration),
    swim_ev.ProtocolDelayComputeEvent: lambda rp, e: rp.stat_timing("protocol.delay", e.duration),
    swim_ev.ProtocolFrequencyEvent: lambda rp, e: rp.stat_timing("protocol.frequency", e.duration),
    swim_ev.ChecksumComputeEvent: Ringpop._on_checksum_computed,
    swim_ev.ChangesCalculatedEvent: lambda rp, e: rp.stat_gauge("changes.disseminate", len(e.changes)),
    swim_ev.ChangeFilteredEvent: lambda rp, e: rp.stat_incr("filtered-change"),
    swim_ev.RefuteUpdateEvent: lambda rp, e: rp.stat_incr("refuted-update"),
    swim_ev.RequestBeforeReadyEvent: lambda rp, e: rp.stat_incr(
        "not-ready.ping" if "ping" in e.endpoint else "not-ready.ping-req"
    ),
    swim_ev.DiscoHealEvent: lambda rp, e: rp.stat_incr("heal.triggered"),
    swim_ev.AttemptHealEvent: lambda rp, e: rp.stat_incr("heal.attempt"),
    facade_ev.RingChecksumEvent: lambda rp, e: rp.stat_incr("ring.checksum-computed"),
    facade_ev.RingChangedEvent: Ringpop._on_ring_changed,
    fwd_ev.RequestForwardedEvent: lambda rp, e: rp.stat_incr("requestProxy.egress"),
    fwd_ev.InflightRequestsChangedEvent: lambda rp, e: rp.stat_gauge("requestProxy.inflight", e.inflight),
    fwd_ev.InflightRequestsMiscountEvent: lambda rp, e: rp.stat_incr(f"requestProxy.miscount.{e.operation}"),
    fwd_ev.SuccessEvent: lambda rp, e: rp.stat_incr("requestProxy.send.success"),
    fwd_ev.FailedEvent: lambda rp, e: rp.stat_incr("requestProxy.send.error"),
    fwd_ev.MaxRetriesEvent: lambda rp, e: rp.stat_incr("requestProxy.retry.failed"),
    fwd_ev.RetryAttemptEvent: lambda rp, e: rp.stat_incr("requestProxy.retry.attempted"),
    fwd_ev.RetryAbortEvent: lambda rp, e: rp.stat_incr("requestProxy.retry.aborted"),
    fwd_ev.RetrySuccessEvent: lambda rp, e: rp.stat_incr("requestProxy.retry.succeeded"),
    fwd_ev.RerouteEvent: lambda rp, e: rp.stat_incr("requestProxy.retry.reroute.remote"),
}
