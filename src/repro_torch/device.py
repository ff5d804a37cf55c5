"""Device choice for the port's entry points: the card unless asked otherwise."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "synchronize"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A CUDA device that is not there raises; the
    port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (no-op on the CPU): before a host
    clock is read around device work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
