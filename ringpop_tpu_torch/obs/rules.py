"""Declarative alert rules over the live operations plane (r22).

r20 gave every rank ``/metrics``, ``/healthz`` and ``/progress``; this
module is the first consumer that is not a human: a small rule engine
evaluated over :class:`~ringpop_tpu_torch.obs.aggregate.AggregatingStats`
snapshots and the :class:`~ringpop_tpu_torch.obs.endpoint.LiveOps` health/
progress views, at the same protocol point the obs plane already syncs
(a journal block boundary).  Four predicate families cover the signals
the controller acts on:

* :class:`Threshold` — a counter/gauge/timing statistic crosses a bound;
* :class:`RateOfChange` — the per-evaluation delta of a monotone
  counter leaves a band (a stalled rate is the "rank stopped making
  progress" signal; a spiking one is the suspicion-storm signal);
* :class:`Staleness` — a rank's ``/healthz`` liveness drops (dead or
  stale by snapshot age);
* :class:`CrossRankSkew` — one rank's value diverges from the fleet
  mean by more than a ratio (per-rank serve load, arc diameter).

Every rule runs through one hysteresis state machine
(:class:`_RuleState`): a FIRING threshold with a minimum hold window
(the predicate must hold for ``hold`` consecutive evaluations before
the alert fires) and a separate CLEAR threshold/window — a flapping
signal therefore cannot thrash the controller, which is the whole
point of putting hysteresis here rather than in each mitigation.

Each state TRANSITION (clear→firing, firing→clear) emits exactly one
``kind:"alert"`` journal record carrying the rule id, the observed
value, and a deterministic span (``obs/trace.py`` ids derived from the
rule id + subject + firing ordinal — reruns land identical alert
spans).  Controller actions parent onto that span, so
``obs.trace.chain()`` reconstructs alert → action from the journal
alone.

torch-free: numpy + stdlib only, like the rest of ``obs/``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ringpop_tpu_torch.obs.trace import salt_of, span_id_of, trace_id_of

# the whole-fleet subject of rules that do not name a rank
FLEET = -1


def _resolve(snapshot: dict, source: str, key: str):
    """One rank's observed value for (source, key); None when absent.
    ``source`` is a snapshot family (``counters``/``gauges``/
    ``rates_1m``) or a timing statistic path ``timings.<stat>`` —
    e.g. ``timings.p99`` reads ``snapshot["timings"][key]["p99"]``."""
    if source.startswith("timings."):
        entry = snapshot.get("timings", {}).get(key)
        if entry is None:
            return None
        return entry.get(source.split(".", 1)[1])
    v = snapshot.get(source, {}).get(key)
    return None if v is None else float(v)


class _RuleState:
    """The hysteresis state machine one (rule, subject) pair owns:
    ``update(firing_pred, clear_pred)`` per evaluation, transition
    reported only after the respective hold window is satisfied."""

    __slots__ = ("firing", "_hold_fire", "_hold_clear", "fired_count")

    def __init__(self):
        self.firing = False
        self._hold_fire = 0
        self._hold_clear = 0
        self.fired_count = 0  # firing ordinal — salts the alert span

    def update(
        self, fire: bool, clear: bool, hold: int, hold_clear: int
    ) -> Optional[str]:
        """-> "firing" / "clear" on a transition, else None."""
        if not self.firing:
            self._hold_fire = self._hold_fire + 1 if fire else 0
            if self._hold_fire >= hold:
                self.firing = True
                self._hold_fire = 0
                self.fired_count += 1
                return "firing"
            return None
        self._hold_clear = self._hold_clear + 1 if clear else 0
        if self._hold_clear >= hold_clear:
            self.firing = False
            self._hold_clear = 0
            return "clear"
        return None


@dataclass
class Rule:
    """Base declarative rule: id + hysteresis windows.  Subclasses
    implement :meth:`observe` returning ``{subject: value}`` — one
    hysteresis machine per subject (a rank id, or :data:`FLEET`)."""

    id: str
    hold: int = 1        # consecutive firing evaluations before "firing"
    hold_clear: int = 1  # consecutive clear evaluations before "clear"

    def observe(self, ctx: "EvalContext") -> dict:
        raise NotImplementedError

    def fire_pred(self, value) -> bool:
        raise NotImplementedError

    def clear_pred(self, value) -> bool:
        # default clear = not firing (no hysteresis band)
        return not self.fire_pred(value)


_OPS: dict[str, Callable] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}


@dataclass
class Threshold(Rule):
    """``value <op> firing`` on one rank's (or every rank's) stat.

    ``clear`` is the OTHER edge of the hysteresis band (defaults to the
    firing threshold — no band).  ``per_rank=True`` evaluates every
    rank's snapshot separately (one alert per rank); otherwise only
    rank 0's."""

    key: str = ""
    source: str = "gauges"
    op: str = ">"
    firing: float = 0.0
    clear: Optional[float] = None
    per_rank: bool = False

    def observe(self, ctx: "EvalContext") -> dict:
        if self.per_rank:
            out = {}
            for r, snap in ctx.snapshots.items():
                v = _resolve(snap, self.source, self.key)
                if v is not None:
                    out[r] = v
            return out
        snap = ctx.snapshots.get(0)
        if snap is None:
            return {}
        v = _resolve(snap, self.source, self.key)
        return {} if v is None else {FLEET: v}

    def fire_pred(self, value) -> bool:
        return _OPS[self.op](value, self.firing)

    def clear_pred(self, value) -> bool:
        edge = self.firing if self.clear is None else self.clear
        return not _OPS[self.op](value, edge)


@dataclass
class RateOfChange(Rule):
    """The per-evaluation DELTA of a monotone counter leaves
    ``[low, high]``.  A stalled counter (delta 0 while the run should
    progress) and a spiking one (suspicion storm) both land here; the
    previous observation is kept per rank inside the rule.

    ``spike_ratio`` switches to SELF-CALIBRATING mode (``low``/``high``
    ignored): the observed value becomes the ratio of this delta to the
    previous delta (denominator floored at ``floor`` so a quiet
    baseline can't divide to infinity), and the rule fires on
    ``ratio > spike_ratio``.  An absolute threshold on e.g. probe
    timeouts depends on fleet size, probe fan-out and baseline loss;
    the ratio of consecutive block deltas does not — a zone cut is a
    5–20× step on any of them."""

    key: str = ""
    source: str = "counters"
    low: Optional[float] = None
    high: Optional[float] = None
    spike_ratio: Optional[float] = None
    floor: float = 1.0
    per_rank: bool = True
    _prev: dict = field(default_factory=dict, repr=False)
    _prev_delta: dict = field(default_factory=dict, repr=False)

    def observe(self, ctx: "EvalContext") -> dict:
        out = {}
        ranks = ctx.snapshots if self.per_rank else {0: ctx.snapshots.get(0)}
        for r, snap in ranks.items():
            if snap is None:
                continue
            v = _resolve(snap, self.source, self.key)
            if v is None:
                continue
            subject = r if self.per_rank else FLEET
            prev = self._prev.get(subject)
            self._prev[subject] = v
            if prev is None:
                continue  # first observation has no delta
            delta = v - prev
            if self.spike_ratio is None:
                out[subject] = delta
                continue
            prev_delta = self._prev_delta.get(subject)
            self._prev_delta[subject] = delta
            if prev_delta is None:
                continue  # ratio needs two consecutive deltas
            out[subject] = delta / max(prev_delta, self.floor)
        return out

    def fire_pred(self, value) -> bool:
        if self.spike_ratio is not None:
            return value > self.spike_ratio
        if self.low is not None and value < self.low:
            return True
        if self.high is not None and value > self.high:
            return True
        return False


@dataclass
class Staleness(Rule):
    """A rank's ``/healthz`` liveness drops: ``live == False`` for the
    hold window (dead fabric link, or snapshot age past the stale
    bound).  Observes the health view, not the snapshots — subjects are
    peer ranks only (a rank is never stale to itself)."""

    def observe(self, ctx: "EvalContext") -> dict:
        if ctx.health is None:
            return {}
        out = {}
        for rank_s, entry in ctx.health.get("ranks", {}).items():
            if entry.get("self"):
                continue
            out[int(rank_s)] = 0.0 if entry.get("live") else 1.0
        return out

    def fire_pred(self, value) -> bool:
        return value >= 1.0


@dataclass
class CrossRankSkew(Rule):
    """One rank's value exceeds ``ratio`` × the fleet mean (over the
    ranks that report the key).  The serve-load / arc-diameter skew
    trigger: fires per skewed rank, so the controller knows WHICH rank
    to re-place or drain."""

    key: str = ""
    source: str = "gauges"
    ratio: float = 1.5
    clear_ratio: Optional[float] = None  # default: ratio (no band)
    min_ranks: int = 2

    def observe(self, ctx: "EvalContext") -> dict:
        vals = {}
        for r, snap in ctx.snapshots.items():
            v = _resolve(snap, self.source, self.key)
            if v is not None:
                vals[r] = v
        if len(vals) < self.min_ranks:
            return {}
        mean = sum(vals.values()) / len(vals)
        if mean <= 0:
            return {}
        return {r: v / mean for r, v in vals.items()}

    def fire_pred(self, value) -> bool:
        return value > self.ratio

    def clear_pred(self, value) -> bool:
        edge = self.ratio if self.clear_ratio is None else self.clear_ratio
        return value <= edge


class EvalContext:
    """What one evaluation sees: per-rank snapshots + the rank-0 views."""

    __slots__ = ("snapshots", "health", "progress", "tick")

    def __init__(self, snapshots, health=None, progress=None, tick=None):
        self.snapshots = snapshots or {}
        self.health = health
        self.progress = progress
        self.tick = tick


class RuleEngine:
    """Evaluate a rule set per protocol point; emit transition records.

    ``sink`` takes one record dict per alert transition (a
    ``TelemetryJournal.span``-style callable, a ``JsonlSink``, a
    ``FlightRecorder``, a plain list ``.append`` — same contract as a
    ``Tracer`` sink).  Sink failures are swallowed and counted: the ops
    plane never takes the run down.

    Alert record schema (OBSERVABILITY.md "alert records")::

        {"kind": "alert", "rule": <id>, "state": "firing"|"clear",
         "value": <observed>, "about_rank": <rank or -1 fleet-wide>,
         "tick": <protocol tick or None>, "rank": <emitting rank>,
         "trace": ..., "span": ..., "parent": None, "t": <wall>}

    Span ids are pure functions of (rule id, subject, firing ordinal):
    reruns produce identical alert spans, and a clear record shares its
    firing's trace so one ``chain()`` pulls the whole episode.
    """

    def __init__(self, rules, *, sink, rank: int = 0):
        ids = [r.id for r in rules]
        if len(ids) != len(set(ids)):
            raise ValueError(f"duplicate rule ids: {sorted(ids)}")
        self.rules = list(rules)
        self.sink = sink
        self.rank = rank
        self._states: dict[tuple[str, int], _RuleState] = {}
        self.alerts_emitted = 0
        self.alerts_dropped = 0

    def state(self, rule_id: str, subject: int = FLEET) -> Optional[bool]:
        """True/False = firing/clear; None = never observed."""
        st = self._states.get((rule_id, subject))
        return None if st is None else st.firing

    def firing(self) -> list[tuple[str, int]]:
        """Every (rule id, subject) currently in the firing state."""
        return sorted(
            key for key, st in self._states.items() if st.firing
        )

    def evaluate(
        self,
        snapshots: dict[int, dict],
        *,
        health: Optional[dict] = None,
        progress: Optional[dict] = None,
        tick: Optional[int] = None,
    ) -> list[dict]:
        """One evaluation over the fleet's current views; returns the
        alert records emitted this round (also delivered to the sink)."""
        ctx = EvalContext(snapshots, health, progress, tick)
        out: list[dict] = []
        for rule in self.rules:
            try:
                observed = rule.observe(ctx)
            except Exception:
                continue  # a broken rule must not starve the others
            for subject, value in sorted(observed.items()):
                st = self._states.setdefault(
                    (rule.id, subject), _RuleState()
                )
                transition = st.update(
                    rule.fire_pred(value),
                    rule.clear_pred(value),
                    rule.hold,
                    rule.hold_clear,
                )
                if transition is None:
                    continue
                out.append(
                    self._emit(rule, subject, value, transition, st, tick)
                )
        return out

    def _emit(
        self, rule: Rule, subject: int, value, transition: str,
        st: _RuleState, tick,
    ) -> dict:
        # deterministic ids: the trace names the episode (rule, subject,
        # firing ordinal), the span names the transition within it —
        # a clear shares its firing's trace so chain() joins them
        trace = trace_id_of(salt_of("alert", rule.id, subject, st.fired_count))
        record = {
            "kind": "alert",
            "rule": rule.id,
            "state": transition,
            "value": round(float(value), 6),
            "about_rank": subject,
            "tick": tick,
            "rank": self.rank,
            "trace": trace,
            "span": span_id_of(trace, "alert", salt=salt_of(transition)),
            "parent": None,
            "t": time.time(),
        }
        try:
            self.sink(record)
            self.alerts_emitted += 1
        except Exception:
            self.alerts_dropped += 1
        return record
