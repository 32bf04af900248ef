"""Suspicion subsystem: timer-driven member state lifecycle
(parity: reference ``swim/state_transitions.go``).

Suspect→Faulty, Faulty→Tombstone, Tombstone→evict after configured timeouts
(``state_transitions.go:90-117``).  One pending transition per member: a
same-state reschedule is ignored, a cross-state one replaces the timer; the
local node never gets a timer (``state_transitions.go:119-160``).  Timers run
on the node's mockable clock — the deadline-wheel design shared with the sim
plane's deadline arrays.

Counterpart of ``ringpop_tpu/swim/state_transitions.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch import util
from ringpop_tpu_torch.swim.member import FAULTY, SUSPECT, TOMBSTONE


@dataclass
class StateTimeouts:
    """Seconds; zero selects the default
    (parity: ``state_transitions.go:59-76``)."""

    suspect: float = 0.0
    faulty: float = 0.0
    tombstone: float = 0.0

    def merged_with(self, defaults: "StateTimeouts") -> "StateTimeouts":
        return StateTimeouts(
            suspect=util.select_duration(self.suspect, defaults.suspect),
            faulty=util.select_duration(self.faulty, defaults.faulty),
            tombstone=util.select_duration(self.tombstone, defaults.tombstone),
        )


# reference defaults (swim/node.go:74-78)
DEFAULT_TIMEOUTS = StateTimeouts(suspect=5.0, faulty=24 * 60 * 60.0, tombstone=60.0)


class _TransitionTimer:
    __slots__ = ("timer", "state")

    def __init__(self, timer, state: int):
        self.timer = timer
        self.state = state


class StateTransitions:
    def __init__(self, node, timeouts: StateTimeouts):
        self.node = node
        self.timeouts = timeouts.merged_with(DEFAULT_TIMEOUTS)
        self.timers: dict[str, _TransitionTimer] = {}
        self.enabled = True
        self.logger = logging_mod.logger("stateTransitions").with_field("local", node.address)

    def schedule_suspect_to_faulty(self, subject) -> None:
        self._schedule(
            subject,
            SUSPECT,
            self.timeouts.suspect,
            lambda: self.node.memberlist.make_faulty(subject.address, subject.incarnation),
        )

    def schedule_faulty_to_tombstone(self, subject) -> None:
        self._schedule(
            subject,
            FAULTY,
            self.timeouts.faulty,
            lambda: self.node.memberlist.make_tombstone(subject.address, subject.incarnation),
        )

    def schedule_tombstone_to_evict(self, subject) -> None:
        self._schedule(
            subject,
            TOMBSTONE,
            self.timeouts.tombstone,
            lambda: self.node.memberlist.evict(subject.address),
        )

    def _schedule(self, subject, state: int, timeout: float, transition: Callable[[], None]) -> None:
        if not self.enabled:
            self.logger.warn("cannot schedule a transition while disabled")
            return
        if self.node.address == subject.address:
            self.logger.warn("refusing transition timer for the local member")
            return
        existing = self.timers.get(subject.address)
        if existing is not None:
            if existing.state == state:
                return  # dedup same-state reschedule
            existing.timer.stop()

        def fire():
            # the timer may have been replaced/cancelled between fire and run
            cur = self.timers.get(subject.address)
            if cur is None or cur.state != state:
                return
            del self.timers[subject.address]
            transition()

        timer = self.node.clock.after(timeout, fire)
        self.timers[subject.address] = _TransitionTimer(timer, state)

    def cancel(self, subject) -> None:
        existing = self.timers.pop(subject.address, None)
        if existing is not None:
            existing.timer.stop()

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        """Stop-the-world: cancel everything
        (parity: ``state_transitions.go:179-213``)."""
        self.enabled = False
        for t in self.timers.values():
            t.timer.stop()
        self.timers.clear()

    def timer(self, address: str):
        t = self.timers.get(address)
        return t.timer if t else None
