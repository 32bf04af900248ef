"""AggregatingStats: the snapshot-able stats sink of the live plane.

The existing reporters (``cli/stats.py``) stream every emission OUT —
a file line or a UDP datagram per stat — which is the right shape for an
external statsd, and the wrong one for a pull endpoint: ``/metrics``
needs the CURRENT value of every key on demand.  This reporter keeps the
run's counters/gauges/timings in memory, backed by the same
``util/metrics`` primitives the host plane already uses (uniform-sample
:class:`~ringpop_tpu_torch.util.metrics.Histogram` for timings, 1-minute EWMA
:class:`~ringpop_tpu_torch.util.metrics.Meter` per counter), and renders
snapshots in the Prometheus text exposition format.

Both stat planes feed it through their existing seams: the host plane
via ``Options(stats_reporter=...)``, the sim plane via
``telemetry.emit_stats`` (the ``LiveOps`` endpoint wires the latter).
Thread-safe — the serve tier emits from its asyncio loop while the HTTP
endpoint snapshots from its own thread.
"""

from __future__ import annotations

import re
import threading
from typing import Optional

from ringpop_tpu_torch.util.metrics import Histogram, Meter

# timing summary quantiles rendered into snapshots / the endpoint
TIMING_QUANTILES = (0.5, 0.95, 0.99)


class AggregatingStats:
    """In-memory ``StatsReporter`` with a consistent ``snapshot()``.

    Counters sum, gauges keep the last value, timings feed a reservoir
    histogram (``sample_size`` values retained) and every counter key
    additionally drives a 1-minute rate meter.  Duck-typed to
    ``options.StatsReporter`` (incr/gauge/timing) so every existing
    emitter — facade, sim bridge, serve tier — plugs in unchanged."""

    def __init__(self, sample_size: int = 128, clock=None):
        self._lock = threading.Lock()
        self._sample_size = sample_size
        self._clock = clock
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self._timings: dict[str, Histogram] = {}
        self._meters: dict[str, Meter] = {}

    def incr(self, key: str, value: int = 1) -> None:
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + value
            meter = self._meters.get(key)
            if meter is None:
                meter = self._meters[key] = Meter(clock=self._clock)
            meter.mark(value)

    def gauge(self, key: str, value: float) -> None:
        with self._lock:
            self.gauges[key] = float(value)

    def timing(self, key: str, seconds: float) -> None:
        with self._lock:
            h = self._timings.get(key)
            if h is None:
                # seed the reservoir rng off the key so reruns sample the
                # same way per key regardless of creation order
                h = self._timings[key] = Histogram(
                    sample_size=self._sample_size,
                    seed=sum(key.encode()) & 0x7FFFFFFF,
                )
            h.update(float(seconds))

    def snapshot(self) -> dict:
        """A plain-JSON view of every key: counters with 1-minute rates,
        gauges, and timing summaries (count/mean/min/max + quantiles)."""
        with self._lock:
            timings = {
                k: {
                    "count": h.count,
                    "mean": h.mean(),
                    "min": h.min(),
                    "max": h.max(),
                    **{
                        f"p{int(q * 100)}": h.percentile(q)
                        for q in TIMING_QUANTILES
                    },
                }
                for k, h in self._timings.items()
            }
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "timings": timings,
                "rates_1m": {k: m.rate1() for k, m in self._meters.items()},
            }

    def clear(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self._timings.clear()
            self._meters.clear()


# -- Prometheus text exposition ----------------------------------------------

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(key: str) -> str:
    """A stats key as a legal Prometheus metric name: every illegal
    character becomes ``_`` (``ringpop.sim.ping.send`` →
    ``ringpop_sim_ping_send``), a leading digit gets a ``_`` prefix."""
    name = _NAME_BAD.sub("_", key)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _fmt(v) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def render_prometheus(snapshots: dict[int, dict]) -> str:
    """``{rank: snapshot}`` → Prometheus text exposition.

    Every sample carries a ``rank`` label; when more than one rank is
    present an UNLABELED aggregate sample follows per counter/gauge
    metric (counters sum, gauges sum — the cross-rank totals the
    live-smoke certifies against the ranks' journal sums).  Timings
    render as real Prometheus ``summary`` families: quantile-labeled
    samples (``name{rank="0",quantile="0.5"}``) plus a ``<name>_count``
    line per rank, with mean/min/max kept as auxiliary ``<name>_mean``
    etc. gauges.  There is deliberately NO ``<name>_sum`` sample: the
    backing :class:`~ringpop_tpu_torch.util.metrics.Histogram` is a uniform
    reservoir (``sample_size`` retained values), so an exact sum over
    all observations does not exist — the exposition comment on each
    summary states this so scrapers don't infer rates from it."""
    lines: list[str] = []
    ranks = sorted(snapshots)
    multi = len(ranks) > 1

    def emit_family(kind: str, prom_type: str, agg: bool) -> None:
        keys = sorted({k for r in ranks for k in snapshots[r].get(kind, {})})
        for key in keys:
            name = prom_name(key)
            lines.append(f"# TYPE {name} {prom_type}")
            total = 0.0
            seen = False
            for r in ranks:
                v = snapshots[r].get(kind, {}).get(key)
                if v is None:
                    continue
                seen = True
                total += float(v)
                lines.append(f'{name}{{rank="{r}"}} {_fmt(v)}')
            if agg and multi and seen:
                lines.append(f"{name} {_fmt(total)}")

    emit_family("counters", "counter", agg=True)
    emit_family("gauges", "gauge", agg=True)
    # timing summaries: quantile-labeled samples + _count, per rank
    tkeys = sorted({k for r in ranks for k in snapshots[r].get("timings", {})})
    for key in tkeys:
        base = prom_name(key)
        lines.append(f"# TYPE {base} summary")
        lines.append(
            f"# {base}: reservoir-sampled quantiles "
            "(uniform sample, not an exact sum — no _sum line; "
            "do not derive rates from this family)"
        )
        aux = sorted(
            {
                s
                for r in ranks
                for s in snapshots[r].get("timings", {}).get(key, {})
                if s not in ("count",) and not s.startswith("p")
            }
        )
        for r in ranks:
            entry = snapshots[r].get("timings", {}).get(key)
            if not entry:
                continue
            for stat in sorted(entry):
                if not stat.startswith("p") or not stat[1:].isdigit():
                    continue
                q = int(stat[1:]) / 100.0
                lines.append(
                    f'{base}{{rank="{r}",quantile="{_fmt(q)}"}} '
                    f"{_fmt(entry[stat])}"
                )
            if "count" in entry:
                lines.append(
                    f'{base}_count{{rank="{r}"}} {_fmt(entry["count"])}'
                )
        for stat in aux:
            name = f"{base}_{stat}"
            lines.append(f"# TYPE {name} gauge")
            for r in ranks:
                v = snapshots[r].get("timings", {}).get(key, {}).get(stat)
                if v is not None:
                    lines.append(f'{name}{{rank="{r}"}} {_fmt(v)}')
    rkeys = sorted({k for r in ranks for k in snapshots[r].get("rates_1m", {})})
    for key in rkeys:
        name = prom_name(key) + "_rate1m"
        lines.append(f"# TYPE {name} gauge")
        for r in ranks:
            v = snapshots[r].get("rates_1m", {}).get(key)
            if v is not None:
                lines.append(f'{name}{{rank="{r}"}} {_fmt(v)}')
    return "\n".join(lines) + "\n"


def merge_counter_totals(snapshots: dict[int, dict]) -> dict[str, float]:
    """Cross-rank counter sums — the aggregation the endpoint's
    unlabeled samples expose, callable directly for tests/tools."""
    out: dict[str, float] = {}
    for snap in snapshots.values():
        for k, v in snap.get("counters", {}).items():
            out[k] = out.get(k, 0.0) + float(v)
    return out
