"""Where the port's state lives: the default device and its check.

Counterpart of the probe half of ``ringpop_tpu/util/accel.py``.  Entry
points that create device state default to the CUDA card and raise when
there is none; the plain PyTorch path on the CPU is taken only when the
caller asks for it with ``device="cpu"`` — never as a silent fallback.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``, ``cuda`` when None.  Raises
    RuntimeError for a CUDA device when no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the host"
        )
    return dev
