"""Portfolio head for /predict (counterpart of
vqvaehmm_tpu/models/portfolio.py::RegimePortfolioOptimizer).

The other heads of the JAX package's zoo are still to be ported
(ROADMAP.md)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops import nn as ops


@dataclass(frozen=True)
class HeadConfig:
    K: int = 3
    n_assets: int = 10
    hidden_dim: int = 64


class RegimePortfolioOptimizer(nn.Module):
    """MLP K -> h -> h -> n_assets with softmax weights.  Parameter names
    are the reference's state_dict keys (net.{0,2,4})."""

    def __init__(self, cfg: HeadConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.net = nn.Sequential(
            nn.Linear(cfg.K, cfg.hidden_dim, device=device), nn.ReLU(),
            nn.Linear(cfg.hidden_dim, cfg.hidden_dim, device=device),
            nn.ReLU(),
            nn.Linear(cfg.hidden_dim, cfg.n_assets, device=device))
        for i in (0, 2, 4):
            ops.init_linear_(self.net[i], generator)

    def forward(self, regime_probs: torch.Tensor) -> torch.Tensor:
        """(B, K) or (B, K, T) regime probabilities -> (B, n_assets)
        weights; a 3-D input is read at its last time step."""
        q = regime_probs[:, :, -1] if regime_probs.dim() == 3 \
            else regime_probs
        return torch.softmax(self.net(q), dim=-1)
