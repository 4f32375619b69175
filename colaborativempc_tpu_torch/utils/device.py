"""Device resolution shared by every constructor that places tensors."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; asking for CUDA without a card
    raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU), so a
    host clock read after it covers that work."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
