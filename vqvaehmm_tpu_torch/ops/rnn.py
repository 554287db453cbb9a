"""The LSTM of the sequential downstream models (counterpart of
vqvaehmm_tpu/ops/rnn.py).

The JAX package writes the recurrence by hand with torch.nn.LSTM's
parameters: per layer weight_ih (4H, D), weight_hh (4H, H), bias_ih
(4H,), bias_hh (4H,), gates in the order input, forget, cell, output.
So the port uses nn.LSTM(batch_first=True) itself, initialised from a
Generator as the JAX init draws (U(-1/sqrt(H), 1/sqrt(H)) for every
array), and `lstm_state_from_numpy` carries the JAX layer list across.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .nn import kaiming_uniform_

_LEAVES = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")


def make_lstm(input_dim: int, hidden_dim: int, num_layers: int = 1,
              device=None, generator: Optional[torch.Generator] = None
              ) -> nn.LSTM:
    """nn.LSTM(batch_first=True) with every array drawn from `generator`
    (on the CPU, so a seed gives the same weights on every device)."""
    lstm = nn.LSTM(input_dim, hidden_dim, num_layers, batch_first=True,
                   device=device)
    for p in lstm.parameters():
        kaiming_uniform_(p, hidden_dim, generator)
    return lstm


def lstm_state_from_numpy(layers: Sequence[Mapping[str, np.ndarray]],
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """The JAX package's LSTM layer list -> nn.LSTM's state_dict entries
    (`{prefix}weight_ih_l{i}`, ...), float32."""
    out = {}
    for i, layer in enumerate(layers):
        if sorted(layer) != sorted(_LEAVES):
            raise KeyError(f"LSTM layer {i} has {sorted(layer)}, expected "
                           f"{sorted(_LEAVES)}")
        for leaf in _LEAVES:
            out[f"{prefix}{leaf}_l{i}"] = torch.from_numpy(
                np.array(layer[leaf], dtype=np.float32, copy=True))
    return out
