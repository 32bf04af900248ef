"""Typed SWIM events (parity: reference ``swim/events.go:40-236``).

The facade maps these to stats (``ringpop.go:385-548``); tests subscribe via
``ringpop_tpu_torch.events.on``.

Counterpart of ``ringpop_tpu/swim/events.py``, copied with its imports pointed at
the port; it imports no torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List


@dataclass
class MaxPAdjustedEvent:
    old_pcount: int = 0
    new_pcount: int = 0


@dataclass
class MemberlistChangesReceivedEvent:
    changes: List[Any] = field(default_factory=list)


@dataclass
class MemberlistChangesAppliedEvent:
    changes: List[Any] = field(default_factory=list)
    old_checksum: int = 0
    new_checksum: int = 0
    num_members: int = 0


@dataclass
class FullSyncEvent:
    remote: str = ""
    remote_checksum: int = 0


@dataclass
class StartReverseFullSyncEvent:
    target: str = ""


@dataclass
class OmitReverseFullSyncEvent:
    target: str = ""


@dataclass
class RedundantReverseFullSyncEvent:
    target: str = ""


@dataclass
class JoinReceiveEvent:
    local: str = ""
    source: str = ""


@dataclass
class JoinCompleteEvent:
    duration: float = 0.0
    num_joined: int = 0
    joined: List[str] = field(default_factory=list)


@dataclass
class JoinFailedEvent:
    reason: str = ""
    error: str = ""


@dataclass
class JoinTriesUpdateEvent:
    retries: int = 0


@dataclass
class PingSendEvent:
    local: str = ""
    remote: str = ""
    changes: List[Any] = field(default_factory=list)


@dataclass
class PingSendCompleteEvent:
    local: str = ""
    remote: str = ""
    changes: List[Any] = field(default_factory=list)
    duration: float = 0.0


@dataclass
class PingReceiveEvent:
    local: str = ""
    source: str = ""
    changes: List[Any] = field(default_factory=list)


@dataclass
class PingRequestsSendEvent:
    local: str = ""
    target: str = ""
    peers: List[str] = field(default_factory=list)


@dataclass
class PingRequestsSendCompleteEvent:
    local: str = ""
    target: str = ""
    peers: List[str] = field(default_factory=list)
    peer: str = ""
    duration: float = 0.0


@dataclass
class PingRequestSendErrorEvent:
    local: str = ""
    target: str = ""
    peers: List[str] = field(default_factory=list)
    peer: str = ""


@dataclass
class PingRequestReceiveEvent:
    local: str = ""
    source: str = ""
    target: str = ""
    changes: List[Any] = field(default_factory=list)


@dataclass
class PingRequestPingEvent:
    local: str = ""
    source: str = ""
    target: str = ""
    duration: float = 0.0


@dataclass
class ProtocolDelayComputeEvent:
    duration: float = 0.0


@dataclass
class ProtocolFrequencyEvent:
    duration: float = 0.0


@dataclass
class ChecksumComputeEvent:
    duration: float = 0.0
    checksum: int = 0
    old_checksum: int = 0


@dataclass
class ChangesCalculatedEvent:
    changes: List[Any] = field(default_factory=list)


@dataclass
class ChangeFilteredEvent:
    change: Any = None


@dataclass
class RequestBeforeReadyEvent:
    endpoint: str = ""


@dataclass
class RefuteUpdateEvent:
    pass


@dataclass
class MakeNodeStatusEvent:
    status: int = 0


@dataclass
class AttemptHealEvent:
    pass


@dataclass
class DiscoHealEvent:
    pass


@dataclass
class AddJoinListEvent:
    duration: float = 0.0


@dataclass
class SelfEvictedEvent:
    phases: List[Any] = field(default_factory=list)
