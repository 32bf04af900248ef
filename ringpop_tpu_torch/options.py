"""The stats sinks of the facade's options (parity: ``bark.StatsReporter``).

Counterpart of the ``StatsReporter`` half of ``ringpop_tpu/options.py``:
the sim plane's telemetry bridge (``sim/telemetry.emit_stats``) feeds any
of these, so one collection pipeline serves both planes.
"""

from __future__ import annotations


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
