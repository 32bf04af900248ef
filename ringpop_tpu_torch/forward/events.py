"""Forwarder events (parity: reference ``forward/events.go`` — 11 types)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RequestForwardedEvent:
    pass


@dataclass
class InflightRequestsChangedEvent:
    inflight: int = 0


@dataclass
class InflightRequestsMiscountEvent:
    operation: str = ""


@dataclass
class SuccessEvent:
    pass


@dataclass
class FailedEvent:
    pass


@dataclass
class MaxRetriesEvent:
    max_retries: int = 0


@dataclass
class RetryAttemptEvent:
    pass


@dataclass
class RetryAbortEvent:
    reason: str = ""


@dataclass
class RetrySuccessEvent:
    num_retries: int = 0


@dataclass
class RerouteEvent:
    old_destination: str = ""
    new_destination: str = ""


@dataclass
class RetryScheduledEvent:
    delay: float = 0.0
