"""One forwarding attempt + the retry engine
(parity: reference ``forward/request_sender.go``).

Retries sleep per the schedule, then **re-look-up all keys**: if the keys'
destinations diverged while we were retrying, abort with
:class:`DestinationsDivergedError` (``request_sender.go:222-243``); with
reroute enabled a moved-but-consistent destination is chased
(``request_sender.go:245-254``).
"""

from __future__ import annotations

import asyncio

from ringpop_tpu_torch import logging as logging_mod
from ringpop_tpu_torch.forward import events as ev


class DestinationsDivergedError(Exception):
    """(parity: ``request_sender.go:39`` errDestinationsDiverged)"""

    def __str__(self) -> str:
        return "key destinations have diverged"


class MaxRetriesError(Exception):
    def __str__(self) -> str:
        return "max retries exceeded"


class RequestSender:
    def __init__(
        self, sender, channel, emitter, destination, service, endpoint, body, keys, options
    ):
        self.sender = sender
        self.channel = channel
        self.emitter = emitter
        self.destination = destination
        self.service = service
        self.endpoint = endpoint
        self.body = body
        self.keys = keys
        self.options = options
        self.retries = 0
        self.logger = logging_mod.logger("forwarder")

    async def send(self) -> dict:
        """(parity: ``request_sender.go:95-145`` Send)"""
        from ringpop_tpu_torch.forward.forwarder import set_forwarded_header

        headers = set_forwarded_header(self.options.headers)
        try:
            res = await self.channel.call(
                self.destination,
                self.service,
                self.endpoint,
                self.body,
                headers=headers,
                timeout=self.options.timeout,
            )
            if self.retries > 0:
                self.emitter.emit(ev.RetrySuccessEvent(self.retries))
            return res
        except Exception as forward_error:
            if self.retries < self.options.max_retries:
                return await self.schedule_retry()
            self.logger.warn(
                "max retries exceeded for request to %s %s", self.destination, self.endpoint
            )
            self.emitter.emit(ev.MaxRetriesEvent(self.options.max_retries))
            raise MaxRetriesError() from forward_error

    async def schedule_retry(self) -> dict:
        """(parity: ``request_sender.go:206-220`` ScheduleRetry)"""
        schedule = self.options.retry_schedule
        delay = schedule[min(self.retries, len(schedule) - 1)]
        self.emitter.emit(ev.RetryScheduledEvent(delay))
        await asyncio.sleep(delay)
        return await self.attempt_retry()

    async def attempt_retry(self) -> dict:
        """(parity: ``request_sender.go:222-243`` AttemptRetry)"""
        self.retries += 1
        self.emitter.emit(ev.RetryAttemptEvent())

        dests = self.lookup_keys(self.keys)
        if len(dests) != 1:
            self.emitter.emit(ev.RetryAbortEvent(str(DestinationsDivergedError())))
            raise DestinationsDivergedError()

        if self.options.reroute_retries and dests[0] != self.destination:
            return await self.reroute_retry(dests[0])
        return await self.send()

    async def reroute_retry(self, destination: str) -> dict:
        """(parity: ``request_sender.go:245-254``)"""
        self.emitter.emit(ev.RerouteEvent(self.destination, destination))
        self.destination = destination
        return await self.send()

    def lookup_keys(self, keys: list[str]) -> list[str]:
        """Deduped destinations of all keys
        (parity: ``request_sender.go:259-278``)."""
        dests = set()
        for key in keys:
            try:
                dest = self.sender.lookup(key)
            except Exception:
                continue
            if dest:
                dests.add(dest)
        return sorted(dests)
