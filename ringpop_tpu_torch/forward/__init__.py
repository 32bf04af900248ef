"""Request forwarding (counterpart of ``ringpop_tpu/forward``): the scalar
reference forwarder and the batched, hop-guarded plane with quorum reads.
Imports no torch: serve frontends load it without starting a device
runtime."""

from ringpop_tpu_torch.forward.forwarder import (
    Forwarder,
    Options,
    Sender,
    FORWARDED_HEADER,
    set_forwarded_header,
    has_forwarded_header,
)
from ringpop_tpu_torch.forward.batch import (
    BatchForwarder,
    BlockRouter,
    HOPS_HEADER,
    MaxHopsExceededError,
    QuorumReader,
    quorum_size,
)
from ringpop_tpu_torch.forward.request_sender import DestinationsDivergedError

__all__ = [
    "Forwarder",
    "Options",
    "Sender",
    "FORWARDED_HEADER",
    "set_forwarded_header",
    "has_forwarded_header",
    "DestinationsDivergedError",
    "BatchForwarder",
    "BlockRouter",
    "HOPS_HEADER",
    "MaxHopsExceededError",
    "QuorumReader",
    "quorum_size",
]
