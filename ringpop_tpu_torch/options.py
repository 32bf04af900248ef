"""Facade configuration and its stats sinks (parity: reference ``options.go``
and ``bark.StatsReporter``).

Counterpart of ``ringpop_tpu/options.py``.  The stats reporters feed both
planes: the sim plane's telemetry bridge (``sim/telemetry.emit_stats``) and
the facade (``ringpop.Ringpop``).  ``Options`` is a dataclass with
zero-means-default merging; its defaults mirror ``options.go:327-339``: 100
ring replica points, identity from the channel, stats off, checksum stat
timers on periods from ``options.go:204-281``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

from ringpop_tpu_torch import util
from ringpop_tpu_torch.errors import EphemeralIdentityError
from ringpop_tpu_torch.swim.state_transitions import StateTimeouts
from ringpop_tpu_torch.util.clock import Clock


class StatsReporter:
    """Pluggable stats sink (parity: ``bark.StatsReporter``)."""

    def incr(self, key: str, value: int = 1) -> None: ...

    def gauge(self, key: str, value: float) -> None: ...

    def timing(self, key: str, seconds: float) -> None: ...


class NoopStats(StatsReporter):
    """(parity: ``util.go:31-35`` noopStatsReporter)"""

    def incr(self, key, value=1):
        pass

    def gauge(self, key, value):
        pass

    def timing(self, key, seconds):
        pass


class InMemoryStats(StatsReporter):
    """Test/introspection sink: counters summed, gauges last-value, timers
    appended."""

    def __init__(self):
        self.counters: dict[str, int] = {}
        self.gauges: dict[str, float] = {}
        self.timers: dict[str, list[float]] = {}

    def incr(self, key, value=1):
        self.counters[key] = self.counters.get(key, 0) + value

    def gauge(self, key, value):
        self.gauges[key] = value

    def timing(self, key, seconds):
        self.timers.setdefault(key, []).append(seconds)


def default_identity_resolver(channel) -> str:
    """Identity = the channel's listening hostport; ephemeral (port 0)
    identities are refused (parity: ``options.go:184-202`` + ErrEphemeralIdentity)."""
    hostport = channel.hostport
    if not hostport or hostport.endswith(":0"):
        raise EphemeralIdentityError()
    return hostport


@dataclass
class Options:
    """(defaults parity: ``options.go:327-339``)"""

    # ring
    replica_points: int = 100
    hashfunc: Optional[Callable] = None

    # identity
    identity: str = ""
    identity_resolver: Optional[Callable[[], str]] = None

    # stats / logging
    stats_reporter: Optional[StatsReporter] = None

    # swim tuning passthrough (options.go:249-281)
    state_timeouts: StateTimeouts = field(default_factory=StateTimeouts)
    suspect_period: float = 0.0
    faulty_period: float = 0.0
    tombstone_period: float = 0.0

    # stat timers (options.go:204-242)
    membership_checksum_stat_period: float = 5.0
    ring_checksum_stat_period: float = 5.0

    clock: Optional[Clock] = None
    seed: Optional[int] = None

    def resolved_state_timeouts(self) -> StateTimeouts:
        return StateTimeouts(
            suspect=util.select_duration(self.suspect_period, self.state_timeouts.suspect),
            faulty=util.select_duration(self.faulty_period, self.state_timeouts.faulty),
            tombstone=util.select_duration(
                self.tombstone_period, self.state_timeouts.tombstone
            ),
        )
