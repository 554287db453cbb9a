"""Length-mask utilities (counterpart of vqvaehmm_tpu/core/masking.py)."""

from __future__ import annotations

import torch


def length_mask(lengths: torch.Tensor, T: int) -> torch.Tensor:
    """(B,) int lengths -> (B, T) bool mask, True at valid timesteps."""
    return torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]


def pairwise_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) mask -> (B, T-1) mask of valid (t-1, t) transition pairs."""
    return mask[:, 1:] & mask[:, :-1]
