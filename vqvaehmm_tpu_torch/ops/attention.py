"""Self-attention and the transformer encoder of the attention heads
(counterpart of vqvaehmm_tpu/ops/attention.py).

The JAX package writes multi-head self-attention and the post-norm
encoder layer by hand with torch's parameter names (in_proj_weight
(3E, E), in_proj_bias (3E,), out_proj; self_attn, linear1, linear2,
norm1, norm2) and no dropout.  So the port uses nn.MultiheadAttention and
nn.TransformerEncoderLayer themselves: batch_first, dropout 0, ReLU,
post-norm with eps 1e-5, dim_feedforward the head's hidden width.  They
are initialised from a Generator as the JAX init draws (xavier-uniform
in_proj_weight, torch's default Linear draw for out_proj and the feed
forward, zero in_proj_bias and out_proj.bias, LayerNorm ones and zeros),
and `data/checkpoint.py::zoo_params_from_numpy` carries the JAX pytrees
across by name.  Attention is not a Pallas kernel in the JAX package (it
is jnp.einsum and a softmax), so there is no hand-written kernel here.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .nn import init_linear_


def check_heads(embed_dim: int, num_heads: int) -> None:
    """JAX's refusal of a width that the heads do not divide."""
    if embed_dim % num_heads != 0:
        raise ValueError(
            f"embed_dim {embed_dim} not divisible by num_heads {num_heads} "
            "(note: the reference's AttentionPortfolioOptimizer default of "
            "4 heads is unusable at K=3; pick heads dividing K)")


def init_mha_(mha: nn.MultiheadAttention,
              generator: Optional[torch.Generator] = None) -> None:
    """In place: in_proj_weight U(-a, a) with a = sqrt(6 / 2E) (xavier
    uniform), the out projection's weight torch's default Linear draw,
    both biases zero; drawn on the CPU from `generator`."""
    E = mha.embed_dim
    limit = math.sqrt(6.0 / (E + E))
    draw = torch.empty(mha.in_proj_weight.shape).uniform_(
        -limit, limit, generator=generator)
    init_linear_(mha.out_proj, generator)
    with torch.no_grad():
        mha.in_proj_weight.copy_(draw)
        mha.in_proj_bias.zero_()
        mha.out_proj.bias.zero_()


def make_mha(embed_dim: int, num_heads: int, device=None,
             generator: Optional[torch.Generator] = None
             ) -> nn.MultiheadAttention:
    """nn.MultiheadAttention(batch_first=True, dropout 0) with the JAX
    package's initial draw."""
    check_heads(embed_dim, num_heads)
    mha = nn.MultiheadAttention(embed_dim, num_heads, dropout=0.0,
                                batch_first=True, device=device)
    init_mha_(mha, generator)
    return mha


def self_attention(mha: nn.MultiheadAttention,
                   x: torch.Tensor) -> torch.Tensor:
    """Self-attention over x: (B, T, E) -> (B, T, E)."""
    return mha(x, x, x, need_weights=False)[0]


def make_encoder_layer(d_model: int, num_heads: int, dim_ff: int,
                       device=None,
                       generator: Optional[torch.Generator] = None
                       ) -> nn.TransformerEncoderLayer:
    """The JAX package's post-norm encoder layer as
    nn.TransformerEncoderLayer (ReLU, eps 1e-5, dropout 0, batch_first)."""
    check_heads(d_model, num_heads)
    layer = nn.TransformerEncoderLayer(
        d_model, num_heads, dim_feedforward=dim_ff, dropout=0.0,
        activation="relu", layer_norm_eps=1e-5, batch_first=True,
        norm_first=False, device=device)
    init_mha_(layer.self_attn, generator)
    init_linear_(layer.linear1, generator)
    init_linear_(layer.linear2, generator)
    return layer


def make_transformer_encoder(d_model: int, num_heads: int, dim_ff: int,
                             num_layers: int, device=None,
                             generator: Optional[torch.Generator] = None
                             ) -> nn.ModuleList:
    """num_layers encoder layers in a ModuleList (state_dict keys
    `{i}.self_attn.in_proj_weight`, ..., the JAX package's layer list)."""
    return nn.ModuleList(
        make_encoder_layer(d_model, num_heads, dim_ff, device, generator)
        for _ in range(num_layers))
