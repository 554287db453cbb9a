"""Portfolio heads (counterpart of vqvaehmm_tpu/models/portfolio.py):
RegimePortfolioOptimizer, the head behind /predict, and
ImprovedPortfolioOptimizer, the per-regime bank the backtests run and
train/heads.py trains.  The hedgers are models/hedging.py.

The other heads of the JAX package's zoo are still to be ported
(ROADMAP.md queue 1, the rest of the downstream zoo)."""

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


def _last_step(q: torch.Tensor) -> torch.Tensor:
    """(B, K, T) -> (B, K): the final time step.  A 3-D input must be
    (B, K, T), time last, the layout every model-side producer emits; a
    (B, T, K) input is not sniffed here."""
    return q[:, :, -1] if q.dim() == 3 else q


def _as_seq(q: torch.Tensor, K: int) -> torch.Tensor:
    """(B, K, T) or (B, T, K) -> (B, T, K): the reference's shared sniff
    rule (ops/nn.py::as_seq)."""
    return ops.as_seq(q, K)


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
        return torch.softmax(self.net(_last_step(regime_probs)), dim=-1)


class _ExpertLinear(nn.Module):
    """K independent Linear(in, out) layers stacked on a leading axis:
    weight (K, out, in), bias (K, out), the layout of the JAX package's
    stacked pytree."""

    def __init__(self, K: int, in_features: int, out_features: int,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            (K, out_features, in_features), device=device))
        self.bias = nn.Parameter(torch.empty((K, out_features),
                                             device=device))
        ops.kaiming_uniform_(self.weight, in_features, generator)
        ops.kaiming_uniform_(self.bias, in_features, generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """h (K, B, in) or (B, in) shared by the experts -> (K, B, out)."""
        if h.dim() == 2:
            return torch.einsum("koi,bi->kbo", self.weight, h) \
                + self.bias[:, None, :]
        return torch.einsum("koi,kbi->kbo", self.weight, h) \
            + self.bias[:, None, :]


class ImprovedPortfolioOptimizer(nn.Module):
    """Per-regime MLP bank, Linear(K, h) > ReLU > Dropout > Linear(h, h) >
    ReLU > Dropout > Linear(h, A) for each regime, mixed by the regime
    probabilities: weights = sum_k q_k softmax(expert_k(q)).  The K
    experts are stacked (parameters fc{1,2,3}.{weight,bias} with a leading
    K axis, the JAX package's pytree).

    Dropout (rate 0.2) is active only in train() mode and draws its masks
    from the `generator` passed to forward, on that generator's device;
    eval() mode is deterministic."""

    dropout_rate = 0.2

    def __init__(self, cfg: HeadConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.fc1 = _ExpertLinear(cfg.K, cfg.K, cfg.hidden_dim, device,
                                 generator)
        self.fc2 = _ExpertLinear(cfg.K, cfg.hidden_dim, cfg.hidden_dim,
                                 device, generator)
        self.fc3 = _ExpertLinear(cfg.K, cfg.hidden_dim, cfg.n_assets, device,
                                 generator)

    def _drop(self, h: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training:
            return h
        if generator is None:
            raise ValueError("train() mode draws dropout masks: pass "
                             "forward a torch.Generator (or call eval())")
        keep = (torch.rand(h.shape, generator=generator,
                           device=generator.device)
                < 1.0 - self.dropout_rate).to(h.device)
        return torch.where(keep, h / (1.0 - self.dropout_rate),
                           torch.zeros((), dtype=h.dtype, device=h.device))

    def forward(self, regime_probs: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, K) or (B, K, T) regime probabilities -> (B, n_assets)."""
        q = _last_step(regime_probs)
        h = self._drop(torch.relu(self.fc1(q)), generator)
        h = self._drop(torch.relu(self.fc2(h)), generator)
        w = torch.softmax(self.fc3(h), dim=-1)           # (K, B, A)
        return torch.einsum("kba,bk->ba", w, q)
