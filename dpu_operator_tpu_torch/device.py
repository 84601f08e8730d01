"""Where the port's entry points run: the CUDA card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device, owner: str) -> torch.device:
    """``None`` means the CUDA card: the port's entry points run there
    unless the caller asks for the CPU, and with no CUDA device they
    raise rather than fall back to it. A bare ``"cuda"`` gets the
    current device's index."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{owner} runs on a CUDA device by default and none is "
                f"available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{owner}: {device} was asked for and no "
                               f"CUDA device is available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
