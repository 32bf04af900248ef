"""Debounced update logging buffer (parity: reference ``swim/update_rollup.go``).

Buffers applied changes and flushes them as one log line when the stream goes
quiet for ``flush_interval`` — pure observability.

Counterpart of ``ringpop_tpu/swim/rollup.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

from typing import Optional

from ringpop_tpu_torch import logging as logging_mod

DEFAULT_FLUSH_INTERVAL = 5.0  # seconds


class UpdateRollup:
    def __init__(self, node, flush_interval: float = DEFAULT_FLUSH_INTERVAL):
        self.node = node
        self.flush_interval = flush_interval
        self._buffer: list = []
        self._last_update: Optional[float] = None
        self._timer = None
        self.logger = logging_mod.logger("rollup").with_field("local", node.address)

    def track_updates(self, changes: list) -> None:
        """(parity: ``update_rollup.go:95-123``)"""
        if not changes:
            return
        now = self.node.clock.now()
        if self._last_update is not None and now - self._last_update >= self.flush_interval:
            self.flush_buffer()
        self._buffer.extend(changes)
        self._last_update = now
        self._renew_timer()

    def _renew_timer(self) -> None:
        if self._timer is not None:
            self._timer.stop()
        self._timer = self.node.clock.after(self.flush_interval, self.flush_buffer)

    def buffer(self) -> list:
        return list(self._buffer)

    def flush_timer(self):
        return self._timer

    def flush_buffer(self) -> None:
        """(parity: ``update_rollup.go:148-186``)"""
        if self._timer is not None:
            self._timer.stop()
            self._timer = None
        if not self._buffer:
            return
        self.logger.info(
            "membership update rollup: %d updates buffered", len(self._buffer)
        )
        self._buffer.clear()

    def destroy(self) -> None:
        if self._timer is not None:
            self._timer.stop()
            self._timer = None
