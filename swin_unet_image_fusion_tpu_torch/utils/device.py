"""The device check of every entry point: the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def require_device(device: torch.device | str, what: str) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} was asked for a CUDA device and none is available; "
                           "pass device='cpu' to run on the CPU")
    return device
