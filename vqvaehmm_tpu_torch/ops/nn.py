"""Plain NN ops and torch.nn-default initialisation drawn from a Generator.

Counterpart of vqvaehmm_tpu/ops/nn.py.  Weights keep torch's layouts
(Conv1d (O, I, W), Linear (out, in)), which are also the JAX package's,
so parameters cross between the two packages by name alone.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def kaiming_uniform_(tensor: torch.Tensor, fan_in: int,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """In place U(-1/sqrt(fan_in), 1/sqrt(fan_in)): torch's default for
    Conv1d/Linear weights and biases (kaiming_uniform_ with a=sqrt(5)),
    as vqvaehmm_tpu/ops/nn.py:59 draws it.  The draw is made on the CPU
    (where `generator` lives), so a seed gives the same weights on every
    device."""
    bound = math.sqrt(1.0 / fan_in)
    draw = torch.empty(tensor.shape, dtype=tensor.dtype).uniform_(
        -bound, bound, generator=generator)
    with torch.no_grad():
        return tensor.copy_(draw)


def init_conv1d_(conv: torch.nn.Conv1d,
                 generator: Optional[torch.Generator] = None) -> None:
    fan_in = conv.in_channels * conv.kernel_size[0]
    kaiming_uniform_(conv.weight, fan_in, generator)
    kaiming_uniform_(conv.bias, fan_in, generator)


def init_linear_(lin: torch.nn.Linear,
                 generator: Optional[torch.Generator] = None) -> None:
    kaiming_uniform_(lin.weight, lin.in_features, generator)
    kaiming_uniform_(lin.bias, lin.in_features, generator)


def init_embedding_(emb: torch.nn.Embedding,
                    generator: Optional[torch.Generator] = None) -> None:
    # nn.Embedding's default N(0, 1), drawn on the CPU as above
    draw = torch.empty(emb.weight.shape).normal_(generator=generator)
    with torch.no_grad():
        emb.weight.copy_(draw)


def conv1d_same(weight: torch.Tensor, bias: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Stride-1 convolution with zero SAME padding: (B, I, T) -> (B, O, T)."""
    k = weight.shape[-1]
    if k % 2 == 0:
        raise ValueError(f"conv1d_same requires an odd kernel width, got {k}")
    return F.conv1d(x, weight, bias, padding=k // 2)


def conv1d_same_matmul(weight: torch.Tensor, bias: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """conv1d_same as one matrix product over the k shifted copies of x
    (the JAX package's `impl="matmul"` lowering): (O, k*I) @ (B, k*I, T).

    For training on the card where a run must repeat bit for bit: the
    gradient of the weight is then one matrix product with a fixed
    summation order, where cuDNN's default convolution backward adds with
    atomics, and its deterministic algorithm (an FFT) costs many times the
    device time at this model's channel counts."""
    O, I, k = weight.shape
    if k % 2 == 0:
        raise ValueError(f"conv1d_same requires an odd kernel width, got {k}")
    if k == 1:
        cols, w2 = x, weight[:, :, 0]
    else:
        T = x.shape[-1]
        xp = F.pad(x, (k // 2, k // 2))
        cols = torch.cat([xp[:, :, tap:tap + T] for tap in range(k)], dim=1)
        w2 = weight.permute(0, 2, 1).reshape(O, k * I)       # [o, tap*I + i]
    return torch.matmul(w2, cols) + bias[None, :, None]


def linear(weight: torch.Tensor, bias: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """x: (..., in) -> (..., out); weight stored (out, in)."""
    return F.linear(x, weight, bias)


def mlp2(fc1: torch.nn.Linear, fc2: torch.nn.Linear,
         x: torch.Tensor) -> torch.Tensor:
    """Linear -> ReLU -> Linear."""
    return linear(fc2.weight, fc2.bias,
                  torch.relu(linear(fc1.weight, fc1.bias, x)))
