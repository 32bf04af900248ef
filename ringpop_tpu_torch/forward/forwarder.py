"""Request forwarding entry point (parity: reference ``forward/forwarder.go``).

Proxies a keyed request to the owning node.  Defaults mirror the reference:
3 retries on a 3/6/12 s schedule, 3 s per-attempt timeout
(``forwarder.go:56-62``).  The ``ringpop-forwarded`` header breaks forwarding
loops (``forwarder.go:186-203``); generated adapters and the keyed-handler
decorator check it before routing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Protocol

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch.events import EventEmitter
from ringpop_tpu_torch.forward import events as ev
from ringpop_tpu_torch.forward.request_sender import RequestSender

FORWARDED_HEADER = "ringpop-forwarded"

# reference defaults (forwarder.go:56-62)
DEFAULT_MAX_RETRIES = 3
DEFAULT_RETRY_SCHEDULE = (3.0, 6.0, 12.0)
DEFAULT_TIMEOUT = 3.0


def set_forwarded_header(headers: Optional[dict]) -> dict:
    """(parity: ``forwarder.go:186-193`` SetForwardedHeader)"""
    headers = dict(headers or {})
    headers[FORWARDED_HEADER] = "true"
    return headers


def has_forwarded_header(headers: Optional[dict]) -> bool:
    """(parity: ``forwarder.go:196-203`` HasForwardedHeader)"""
    return bool(headers) and headers.get(FORWARDED_HEADER) == "true"


class Sender(Protocol):
    """What the forwarder needs from its host
    (parity: ``forwarder.go:39-45``)."""

    def who_am_i(self) -> str: ...

    def lookup(self, key: str) -> str: ...


@dataclass
class Options:
    """(parity: ``forward/forwarder.go:48-54``)"""

    max_retries: int = DEFAULT_MAX_RETRIES
    retry_schedule: tuple = DEFAULT_RETRY_SCHEDULE
    timeout: float = DEFAULT_TIMEOUT
    reroute_retries: bool = False
    headers: dict = field(default_factory=dict)


class Forwarder:
    def __init__(self, sender: Sender, channel):
        self.sender = sender
        self.channel = channel
        self.emitter = EventEmitter()
        self._inflight = 0
        self.logger = logging_mod.logger("forwarder")

    def register_listener(self, listener) -> None:
        self.emitter.register_listener(listener)

    def emit(self, event) -> None:
        self.emitter.emit(event)

    # inflight gauge with miscount guard (forwarder.go:125-151)
    def _increment_inflight(self) -> None:
        self._inflight += 1
        self.emit(ev.InflightRequestsChangedEvent(self._inflight))

    def _decrement_inflight(self) -> None:
        if self._inflight <= 0:
            self.emit(ev.InflightRequestsMiscountEvent("decrement"))
            return
        self._inflight -= 1
        self.emit(ev.InflightRequestsChangedEvent(self._inflight))

    @property
    def inflight(self) -> int:
        return self._inflight

    async def forward_request(
        self,
        body: dict,
        destination: str,
        service: str,
        endpoint: str,
        keys: list[str],
        options: Optional[Options] = None,
    ) -> dict:
        """Proxy ``body`` to ``destination`` with the retry engine
        (parity: ``forwarder.go:156-174`` ForwardRequest)."""
        opts = options or Options()
        self.emit(ev.RequestForwardedEvent())
        self._increment_inflight()
        sender = RequestSender(
            sender=self.sender,
            channel=self.channel,
            emitter=self.emitter,
            destination=destination,
            service=service,
            endpoint=endpoint,
            body=body,
            keys=keys,
            options=opts,
        )
        try:
            res = await sender.send()
            self.emit(ev.SuccessEvent())
            return res
        except Exception:
            self.emit(ev.FailedEvent())
            raise
        finally:
            self._decrement_inflight()
