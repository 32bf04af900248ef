"""Typed event bus (parity: reference ``events/events.go:26-69``).

The part of ``ringpop_tpu/events`` that the keyed-ownership path needs: the
listener registry and the two ring events a ``HashRing`` emits, which a
``RingStore`` subscribes to.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Protocol


class EventListener(Protocol):
    def handle_event(self, event: Any) -> None: ...


class EventEmitter:
    """Listener registry + synchronous emit (``swim/node.go:266-270``)."""

    def __init__(self) -> None:
        self._listeners: list[EventListener] = []

    def register_listener(self, listener: EventListener) -> None:
        self._listeners.append(listener)

    def deregister_listener(self, listener: EventListener) -> None:
        try:
            self._listeners.remove(listener)
        except ValueError:
            pass

    def emit(self, event: Any) -> None:
        for l in list(self._listeners):
            l.handle_event(event)


@dataclass
class RingChangedEvent:
    servers_added: list = field(default_factory=list)
    servers_updated: list = field(default_factory=list)
    servers_removed: list = field(default_factory=list)


@dataclass
class RingChecksumEvent:
    old_checksum: int = 0
    new_checksum: int = 0
