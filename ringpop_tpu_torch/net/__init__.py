from ringpop_tpu_torch.net.channel import (
    CallError,
    RemoteError,
    CallTimeoutError,
    PeerUnreachableError,
    BaseChannel,
    TCPChannel,
    LocalNetwork,
    LocalChannel,
    encode_array,
    decode_array,
)

__all__ = [
    "CallError",
    "RemoteError",
    "CallTimeoutError",
    "PeerUnreachableError",
    "BaseChannel",
    "TCPChannel",
    "LocalNetwork",
    "LocalChannel",
    "encode_array",
    "decode_array",
]
