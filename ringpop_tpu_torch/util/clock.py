"""Mockable clock (parity: the reference's ``benbjohnson/clock`` dependency).

The host plane schedules suspicion timeouts, gossip periods and stat tickers
through this interface so tests can drive time deterministically — the same
trick the reference test suite uses (``swim/test_utils.go`` mock clocks,
``ringpop_test.go:55-120``).

Timers are a deadline-wheel, not timer-per-member: ``after(delay, fn)``
registers into a sorted deadline list that ``MockClock.advance`` (tests) or the
asyncio loop (production, via :class:`AsyncClockDriver`) fires.  This is the
array-friendly design the sim plane shares (deadlines as int64 arrays).

Counterpart of ``ringpop_tpu/util/clock.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
from typing import Callable, Optional


class Timer:
    """Handle for a scheduled callback; ``stop()`` cancels it."""

    __slots__ = ("deadline", "fn", "_cancelled", "_seq")

    def __init__(self, deadline: float, fn: Callable[[], None], seq: int):
        self.deadline = deadline
        self.fn = fn
        self._cancelled = False
        self._seq = seq

    def stop(self) -> None:
        self._cancelled = True

    @property
    def cancelled(self) -> bool:
        return self._cancelled


class Clock:
    """Base clock: real wall time, timers fired by whoever pumps
    :meth:`fire_due` (the asyncio driver in production)."""

    def __init__(self) -> None:
        self._timers: list[tuple[float, int, Timer]] = []
        self._lock = threading.Lock()
        self._seq = itertools.count()

    def now(self) -> float:
        """Seconds (float, Unix epoch)."""
        return _time.time()

    def now_ms(self) -> int:
        return int(self.now() * 1000)

    def after(self, delay: float, fn: Callable[[], None]) -> Timer:
        """Schedule ``fn`` to run once, ``delay`` seconds from now."""
        with self._lock:
            seq = next(self._seq)
            t = Timer(self.now() + delay, fn, seq)
            heapq.heappush(self._timers, (t.deadline, seq, t))
            return t

    def next_deadline(self) -> Optional[float]:
        with self._lock:
            while self._timers and self._timers[0][2].cancelled:
                heapq.heappop(self._timers)
            return self._timers[0][0] if self._timers else None

    def fire_due(self) -> int:
        """Fire all timers whose deadline has passed; returns count fired."""
        fired = 0
        while True:
            with self._lock:
                while self._timers and self._timers[0][2].cancelled:
                    heapq.heappop(self._timers)
                if not self._timers or self._timers[0][0] > self.now():
                    break
                _, _, t = heapq.heappop(self._timers)
            try:
                t.fn()  # outside the lock: fn may schedule more timers
            except Exception:  # one bad callback must not kill the pump
                import logging

                logging.getLogger("ringpop").exception("timer callback raised")
            fired += 1
        return fired


async def drive_clock(clock: Clock, max_poll: float = 0.05) -> None:
    """Asyncio pump for a real Clock: sleeps until the next deadline (capped
    at ``max_poll`` so newly scheduled earlier timers are picked up) and
    fires due timers.  The production counterpart of MockClock.advance."""
    import asyncio

    while True:
        nd = clock.next_deadline()
        now = clock.now()
        delay = max_poll if nd is None else min(max(nd - now, 0.0), max_poll)
        await asyncio.sleep(delay)
        clock.fire_due()


class MockClock(Clock):
    """Deterministic clock for tests: time only moves via :meth:`advance` /
    :meth:`set`, which also fires due timers in deadline order."""

    def __init__(self, start: float = 0.0) -> None:
        super().__init__()
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> int:
        return self.set(self._now + dt)

    def set(self, t: float) -> int:
        fired = 0
        # step through deadlines so a timer scheduled by a firing timer can
        # itself fire within the same advance window
        while True:
            nd = self.next_deadline()
            if nd is None or nd > t:
                break
            self._now = max(self._now, nd)
            fired += self.fire_due()
        self._now = t
        return fired
