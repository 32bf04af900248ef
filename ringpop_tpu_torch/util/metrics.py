"""Minimal metrics primitives (parity: the reference's ``go-metrics`` usage —
uniform-sample histogram for protocol timing ``swim/gossip.go:65-66`` and
1-minute meters for client/server/total rates ``swim/stats.go``)."""

from __future__ import annotations

import math
import random
import time as _time


class Histogram:
    """Uniform (reservoir) sample histogram."""

    def __init__(self, sample_size: int = 10, seed: int = 0):
        self.sample_size = sample_size
        self._sample: list[float] = []
        self._count = 0
        self._rng = random.Random(seed)

    def update(self, value: float) -> None:
        self._count += 1
        if len(self._sample) < self.sample_size:
            self._sample.append(value)
        else:
            i = self._rng.randrange(self._count)
            if i < self.sample_size:
                self._sample[i] = value

    def percentile(self, p: float) -> float:
        if not self._sample:
            return 0.0
        s = sorted(self._sample)
        idx = p * (len(s) + 1)
        if idx < 1:
            return s[0]
        if idx >= len(s):
            return s[-1]
        lo = s[int(idx) - 1]
        hi = s[int(idx)]
        return lo + (idx - int(idx)) * (hi - lo)

    def percentiles(self, ps: list[float]) -> list[float]:
        return [self.percentile(p) for p in ps]

    @property
    def count(self) -> int:
        return self._count

    def mean(self) -> float:
        return sum(self._sample) / len(self._sample) if self._sample else 0.0

    def min(self) -> float:
        return min(self._sample) if self._sample else 0.0

    def max(self) -> float:
        return max(self._sample) if self._sample else 0.0


class Meter:
    """EWMA rate meter (1-minute), mark()-based."""

    _ALPHA_1M = 1 - math.exp(-5.0 / 60.0)

    def __init__(self, clock=None):
        self._clock = clock
        self._count = 0
        self._rate = 0.0
        self._uncounted = 0
        self._last_tick = self._now()

    def _now(self) -> float:
        return self._clock.now() if self._clock is not None else _time.time()

    def mark(self, n: int = 1) -> None:
        self._tick_if_needed()
        self._count += n
        self._uncounted += n

    def _tick_if_needed(self) -> None:
        now = self._now()
        while now - self._last_tick >= 5.0:
            inst = self._uncounted / 5.0
            self._uncounted = 0
            self._rate += self._ALPHA_1M * (inst - self._rate)
            self._last_tick += 5.0

    @property
    def count(self) -> int:
        return self._count

    def rate1(self) -> float:
        self._tick_if_needed()
        return self._rate
