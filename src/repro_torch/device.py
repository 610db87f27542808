"""Device resolution for the port's public entry points.

Every entry point takes ``device=None``, which means the CUDA card.  A
caller that wants the CPU says so (``device="cpu"``, as the tests do);
there is no silent fall back to the CPU when no card is present.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise when a CUDA device is asked for and
    none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device and none is available; pass "
            "device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

