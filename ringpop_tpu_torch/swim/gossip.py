"""Gossip protocol-period driver (parity: reference ``swim/gossip.go``).

One asyncio task runs ``protocol_period → sleep(delay)``; the delay
self-tunes: ``delay = max(last_period + last_rate - now, min_period)`` with
the rate re-computed every second as 2× the median of observed period timings
(``gossip.go:88-115``) — slow networks automatically slow the gossip.
Tests drive :meth:`protocol_period` directly, the reference test suite's
synchronous-drive trick (``swim/test_utils.go:164-199``).

Counterpart of ``ringpop_tpu/swim/gossip.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

import asyncio
import random
from typing import Optional

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch.swim import events as ev
from ringpop_tpu_torch.util.metrics import Histogram

DEFAULT_MIN_PROTOCOL_PERIOD = 0.2  # 200ms (swim/node.go:80)


class Gossip:
    def __init__(
        self,
        node,
        min_protocol_period: float = DEFAULT_MIN_PROTOCOL_PERIOD,
        rng: Optional[random.Random] = None,
    ):
        self.node = node
        self.min_protocol_period = min_protocol_period
        self._rng = rng or random.Random()
        self._stopped = True
        self.timing = Histogram(sample_size=10)
        self.timing.update(min_protocol_period)
        self._last_period: Optional[float] = None
        self._last_rate: float = min_protocol_period
        self._num_periods = 0
        self._period_task: Optional[asyncio.Task] = None
        self._rate_task: Optional[asyncio.Task] = None
        self.logger = logging_mod.logger("gossip").with_field("local", node.address)

    def stopped(self) -> bool:
        return self._stopped

    # -- self-tuning (parity: gossip.go:88-115) -----------------------------

    def compute_protocol_delay(self) -> float:
        if self._num_periods != 0:
            target = self._last_period + self._last_rate
            return max(target - self.node.clock.now(), self.min_protocol_period)
        # first tick fires at a random point within one period
        return self._rng.uniform(0, self.min_protocol_period)

    def protocol_rate(self) -> float:
        return self._last_rate

    def adjust_protocol_rate(self) -> None:
        observed = self.timing.percentile(0.5) * 2.0
        self._last_rate = max(observed, self.min_protocol_period)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        if not self._stopped:
            self.logger.warn("gossip already started")
            return
        self._stopped = False
        self._period_task = asyncio.ensure_future(self._run_protocol_period_loop())
        self._rate_task = asyncio.ensure_future(self._run_protocol_rate_loop())

    def stop(self) -> None:
        if self._stopped:
            self.logger.warn("gossip already stopped")
            return
        self._stopped = True
        for t in (self._period_task, self._rate_task):
            if t is not None:
                t.cancel()
        self._period_task = self._rate_task = None

    async def _run_protocol_period_loop(self) -> None:
        try:
            while not self._stopped:
                delay = self.compute_protocol_delay()
                self.node.emit(ev.ProtocolDelayComputeEvent(delay))
                t0 = self.node.clock.now()
                await self.protocol_period()
                await asyncio.sleep(delay)
                self.node.emit(ev.ProtocolFrequencyEvent(self.node.clock.now() - t0))
        except asyncio.CancelledError:
            pass

    async def _run_protocol_rate_loop(self) -> None:
        try:
            while not self._stopped:
                await asyncio.sleep(1.0)
                self.adjust_protocol_rate()
        except asyncio.CancelledError:
            pass

    # -- one period (parity: gossip.go:178-188) -----------------------------

    async def protocol_period(self) -> None:
        start = self.node.clock.now()
        await self.node.ping_next_member()
        self._last_period = self.node.clock.now()
        self._num_periods += 1
        self.timing.update(self.node.clock.now() - start)
