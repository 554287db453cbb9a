"""Operand roundings of a product: what a lower precision does to a
float32 operand before the multiply (the sums stay float32).

`exact` is the reference.  The others are the controls, one step below
a configuration's stated precision: `tf32` below float32 with TF32 off,
`bf16` below other float32, `fp8` below bfloat16."""

from __future__ import annotations

import torch


def exact(t: torch.Tensor) -> torch.Tensor:
    return t


def tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 explicit mantissa bits, to nearest,
    ties to even, as the tensor cores read an operand."""
    bits = t.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & -0x2000).view(torch.float32)


def bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16 (8 significant bits)."""
    return t.to(torch.bfloat16).to(torch.float32)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude maps to e4m3's largest finite value, 448), as fp8 matmuls
    are fed."""
    amax = t.detach().abs().max()
    if not bool(amax > 0):
        return t.float()
    scale = amax.float() / 448.0
    return (t.float() / scale).to(torch.float8_e4m3fn).to(torch.float32) \
        * scale


BY_NAME = {"exact": exact, "tf32": tf32, "bf16": bf16, "fp8": fp8}
