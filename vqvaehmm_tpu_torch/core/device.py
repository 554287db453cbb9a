"""The one place a device string becomes a torch.device."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA device on a machine without a usable
    GPU raises instead of moving the work to the CPU quietly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def canonical_device(device) -> torch.device:
    """resolve_device(device) spelled one way: a CUDA device without an
    index gets the current one (so "cuda", "cuda:0" and torch.device("cuda")
    name one device), and the CPU carries no index ("cpu:0" is "cpu")."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev
