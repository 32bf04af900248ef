"""Typed event bus (parity: reference ``events/events.go:26-69``).

Counterpart of ``ringpop_tpu/events`` (a package there, a module here): the
listener registry and ``on``, the two ring events a ``HashRing`` emits,
which a ``RingStore`` subscribes to, the facade's lookup and lifecycle
events, and the sim plane's telemetry block event.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Protocol, Type


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


class _FnListener:
    def __init__(self, event_type: Type, fn: Callable[[Any], None]):
        self.event_type = event_type
        self.fn = fn

    def handle_event(self, event: Any) -> None:
        if isinstance(event, self.event_type):
            self.fn(event)


def on(emitter: EventEmitter, event_type: Type, fn: Callable[[Any], None]) -> _FnListener:
    """Subscribe ``fn`` to events of ``event_type`` (parity: the reference's
    test helper ``swim/events.go:240-246``)."""
    l = _FnListener(event_type, fn)
    emitter.register_listener(l)
    return l


@dataclass
class RingChangedEvent:
    servers_added: list = field(default_factory=list)
    servers_updated: list = field(default_factory=list)
    servers_removed: list = field(default_factory=list)


@dataclass
class RingChecksumEvent:
    old_checksum: int = 0
    new_checksum: int = 0


@dataclass
class LookupEvent:
    key: str = ""
    duration: float = 0.0


@dataclass
class LookupNEvent:
    key: str = ""
    n: int = 0
    duration: float = 0.0


@dataclass
class LookupNBatchEvent:
    """One batched preference-list computation (``lookup_n_batch``):
    ``duration`` covers the whole batch of ``n_keys`` keys."""

    n_keys: int = 0
    n: int = 0
    duration: float = 0.0


@dataclass
class SimTickBlockEvent:
    """One fetched sim-plane telemetry block (``sim/telemetry.py``): the
    per-tick protocol counters accumulated on the device over a tick block,
    reduced and brought to the host in one fetch.  ``record`` is the flat
    scalar dict of OBSERVABILITY.md's journal record schema."""

    record: dict = field(default_factory=dict)


@dataclass
class Ready:
    pass


@dataclass
class Destroyed:
    pass
