"""Plain NN ops and torch.nn-default initialisation drawn from a Generator.

Counterpart of vqvaehmm_tpu/ops/nn.py.  Weights keep torch's layouts
(Conv1d (O, I, W), Linear (out, in)), which are also the JAX package's,
so parameters cross between the two packages by name alone.

The bf16-operand products (`bf16_matmul`, `conv1d_same_bf16`,
`linear_bf16`) are the arithmetic of the train kernel's bfloat16 mode
(vqvaehmm_tpu/ops/pallas_train.py::_make_dots with bf16_matmuls): both
operands of every product rounded to bfloat16, the sums in float32, every
other value float32.  A product of two bfloat16 values is exact in
float32, so they differ from the kernel only in the order of the sums.
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


def _matmul_operands(weight: torch.Tensor, x: torch.Tensor):
    """(w2, cols) with conv1d_same(weight, 0, x) == w2 @ cols: the weight
    as (O, k*I) and the k shifted copies of x stacked on channels."""
    O, I, k = weight.shape
    if k % 2 == 0:
        raise ValueError(f"conv1d_same requires an odd kernel width, got {k}")
    if k == 1:
        return weight[:, :, 0], x
    T = x.shape[-1]
    xp = F.pad(x, (k // 2, k // 2))
    cols = torch.cat([xp[:, :, tap:tap + T] for tap in range(k)], dim=1)
    return weight.permute(0, 2, 1).reshape(O, k * I), cols  # [o, tap*I + i]


def conv1d_same_matmul(weight: torch.Tensor, bias: torch.Tensor,
                       x: torch.Tensor) -> torch.Tensor:
    """conv1d_same as one matrix product over the k shifted copies of x
    (the JAX package's `impl="matmul"` lowering): (O, k*I) @ (B, k*I, T).

    For training on the card where a run must repeat bit for bit: the
    gradient of the weight is then one matrix product with a fixed
    summation order, where cuDNN's default convolution backward adds with
    atomics, and its deterministic algorithm (an FFT) costs many times the
    device time at this model's channel counts."""
    w2, cols = _matmul_operands(weight, x)
    return torch.matmul(w2, cols) + bias[None, :, None]


def as_seq(q: torch.Tensor, K: int) -> torch.Tensor:
    """A regime-probability tensor as (B, T, K).  The reference's
    dimension sniff (vqvaehmm_tpu/ops/nn.py:33): a 3-D input whose dim 1
    equals K is read as (B, K, T) and transposed, so a square input
    (T == K) is transposed too."""
    if q.dim() == 3 and q.shape[1] == K:
        return q.transpose(1, 2)
    return q


def linear(weight: torch.Tensor, bias: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """x: (..., in) -> (..., out); weight stored (out, in)."""
    return F.linear(x, weight, bias)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to the nearest bfloat16 (ties to even, as XLA's convert
    rounds), back in float32."""
    return t.to(torch.bfloat16).float()


class _BF16OperandMatmul(torch.autograd.Function):
    """a @ b with both operands rounded to bfloat16 and float32 sums; the
    backward's two products round their operands too (g @ b^T and
    a^T @ g), as the kernel's backward does."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = bf16_round(a), bf16_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = bf16_round(g)
        # a batched operand broadcast against the other sums its gradient
        return ((rg @ rb.transpose(-1, -2)).sum_to_size(ra.shape),
                (ra.transpose(-1, -2) @ rg).sum_to_size(rb.shape))


def bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.matmul of float32 a and b with bfloat16-rounded operands."""
    return _BF16OperandMatmul.apply(a, b)


def conv1d_same_bf16(weight: torch.Tensor, bias: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """conv1d_same_matmul with its one product through bf16_matmul: the
    weight and the shifted copies of x rounded to bfloat16, the bias added
    in float32 (its gradient reads the unrounded output gradient)."""
    w2, cols = _matmul_operands(weight, x)
    return bf16_matmul(w2, cols) + bias[None, :, None]


def linear_bf16(weight: torch.Tensor, bias: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """linear with bfloat16-rounded operands: x (..., in) -> (..., out)."""
    return bf16_matmul(x, weight.t()) + bias
