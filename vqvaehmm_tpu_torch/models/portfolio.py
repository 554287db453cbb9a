"""Portfolio heads (counterpart of vqvaehmm_tpu/models/portfolio.py):
the eight architectures of the JAX package's zoo that turn regime
posteriors into softmax weights.  RegimePortfolioOptimizer is the head
behind /predict; ImprovedPortfolioOptimizer the per-regime bank the
backtests run and train/heads.py trains; the attention, transformer,
Bayesian, ensemble, hierarchical and LSTM heads complete the zoo.  The
hedgers are models/hedging.py.

Shared input convention (the reference's dimension sniff): regime
probabilities arrive as (B, K) or (B, K, T); the sequence heads read the
whole (B, T, K) path, the pointwise heads the last time step.  Every
head is an nn.Module with an explicit `device` and a `generator` for its
initial weights; data/checkpoint.py::zoo_params_from_numpy carries the
JAX package's parameters across.  The ensemble keeps its members'
parameters stacked on a leading axis, so one batched product a layer
serves all members, as JAX's vmap does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from ..ops import nn as ops
from ..ops.attention import (make_mha, make_transformer_encoder,
                             self_attention)
from ..ops.rnn import make_lstm


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


def _linear(in_features: int, out_features: int, device,
            generator: Optional[torch.Generator]) -> nn.Linear:
    lin = nn.Linear(in_features, out_features, device=device)
    ops.init_linear_(lin, generator)
    return lin


class AttentionPortfolioOptimizer(nn.Module):
    """Self-attention over the regime path, its last token -> MLP
    (parameters attn.{in_proj_weight, in_proj_bias, out_proj.*},
    fc1.*, fc2.*).  A 2-D (B, K) input skips the attention.  n_heads
    defaults to 1: the reference's 4 does not divide K=3 (ValueError)."""

    def __init__(self, cfg: HeadConfig, n_heads: int = 1, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.n_heads = cfg, n_heads
        self.attn = make_mha(cfg.K, n_heads, device, generator)
        self.fc1 = _linear(cfg.K, cfg.hidden_dim, device, generator)
        self.fc2 = _linear(cfg.hidden_dim, cfg.n_assets, device, generator)

    def forward(self, regime_probs: torch.Tensor) -> torch.Tensor:
        if regime_probs.dim() == 3:
            seq = _as_seq(regime_probs, self.cfg.K)
            q = self_attention(self.attn, seq)[:, -1, :]
        else:
            q = regime_probs
        return torch.softmax(self.fc2(torch.relu(self.fc1(q))), dim=-1)


class TransformerPortfolioOptimizer(nn.Module):
    """A transformer encoder of n_layers (d_model K, feed-forward
    hidden_dim) over the regime path, its last token -> softmax weights
    (parameters encoder.{i}.*, head.*).  A (B, K) input is a length-1
    sequence."""

    def __init__(self, cfg: HeadConfig, n_layers: int = 2, n_heads: int = 1,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.n_layers, self.n_heads = cfg, n_layers, n_heads
        self.encoder = make_transformer_encoder(
            cfg.K, n_heads, cfg.hidden_dim, n_layers, device, generator)
        self.head = _linear(cfg.K, cfg.n_assets, device, generator)

    def forward(self, regime_seq: torch.Tensor) -> torch.Tensor:
        if regime_seq.dim() == 2:
            regime_seq = regime_seq[:, None, :]
        out = _as_seq(regime_seq, self.cfg.K)
        for layer in self.encoder:
            out = layer(out)
        return torch.softmax(self.head(out[:, -1]), dim=-1)


class BayesianPortfolioOptimizer(nn.Module):
    """A variational hidden layer: weights averaged over n_samples draws
    h = relu(fc1_mu(q)) + eps * exp(fc1_logvar(q) / 2), with their ddof=1
    standard deviation on request (parameters fc1_mu.*, fc1_logvar.*,
    fc2.*).

    With neither `generator` nor `eps` given the call is deterministic
    (the mean hidden layer).  All draws are taken at once, eps of shape
    (n_samples, B, hidden_dim) from `generator` (on its device), or `eps`
    as given, so a caller holding the JAX package's draws can hand them
    over."""

    def __init__(self, cfg: HeadConfig, n_samples: int = 10, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.n_samples = cfg, n_samples
        self.fc1_mu = _linear(cfg.K, cfg.hidden_dim, device, generator)
        self.fc1_logvar = _linear(cfg.K, cfg.hidden_dim, device, generator)
        self.fc2 = _linear(cfg.hidden_dim, cfg.n_assets, device, generator)

    def forward(self, regime_probs: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                return_uncertainty: bool = False,
                eps: Optional[torch.Tensor] = None):
        sampled = generator is not None or eps is not None
        if return_uncertainty and not sampled:
            raise ValueError(
                "return_uncertainty=True requires generator= or eps= (MC "
                "sampling); the deterministic path has no uncertainty "
                "estimate")
        if return_uncertainty and self.n_samples < 2:
            raise ValueError(
                "uncertainty needs n_samples >= 2 (ddof=1 std over one "
                "sample is NaN)")
        q = _last_step(regime_probs)
        mu = torch.relu(self.fc1_mu(q))
        logvar = self.fc1_logvar(q)
        if not sampled:
            return torch.softmax(self.fc2(mu), dim=-1)
        if eps is None:
            eps = torch.randn((self.n_samples,) + tuple(mu.shape),
                              generator=generator, device=generator.device,
                              dtype=mu.dtype)
        h = mu[None] + eps.to(mu.device) * torch.exp(0.5 * logvar)[None]
        w = torch.softmax(self.fc2(h), dim=-1)            # (S, B, A)
        weights = w.mean(dim=0)
        if return_uncertainty:
            return weights, w.std(dim=0, correction=1)
        return weights


class EnsemblePortfolioOptimizer(nn.Module):
    """n_models MLPs K -> h -> n_assets, their softmax weights averaged.
    The members' parameters are stacked on a leading axis (fc1.weight
    (n, h, K), ...: the JAX package's stacked pytree), so each layer is
    one batched product over all members."""

    def __init__(self, cfg: HeadConfig, n_models: int = 5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.n_models = cfg, n_models
        self.fc1 = _ExpertLinear(n_models, cfg.K, cfg.hidden_dim, device,
                                 generator)
        self.fc2 = _ExpertLinear(n_models, cfg.hidden_dim, cfg.n_assets,
                                 device, generator)

    def forward(self, regime_probs: torch.Tensor) -> torch.Tensor:
        q = _last_step(regime_probs)
        h = torch.relu(self.fc1(q))                        # (n, B, h)
        return torch.softmax(self.fc2(h), dim=-1).mean(dim=0)


class HierarchicalPortfolioOptimizer(nn.Module):
    """Macro MLP, its output joined with q, micro MLP, head (parameters
    macro.*, micro.*, head.*)."""

    def __init__(self, cfg: HeadConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.macro = _linear(cfg.K, cfg.hidden_dim, device, generator)
        self.micro = _linear(cfg.hidden_dim + cfg.K, cfg.hidden_dim, device,
                             generator)
        self.head = _linear(cfg.hidden_dim, cfg.n_assets, device, generator)

    def forward(self, regime_probs: torch.Tensor) -> torch.Tensor:
        q = _last_step(regime_probs)
        macro = torch.relu(self.macro(q))
        micro = torch.relu(self.micro(torch.cat([macro, q], dim=-1)))
        return torch.softmax(self.head(micro), dim=-1)


class RegimeLSTMOptimizer(nn.Module):
    """An LSTM of num_layers over the regime path, its last hidden state ->
    softmax weights (parameters lstm.weight_ih_l{i}, ..., head.*)."""

    def __init__(self, cfg: HeadConfig, num_layers: int = 2, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.num_layers = cfg, num_layers
        self.lstm = make_lstm(cfg.K, cfg.hidden_dim, num_layers, device,
                              generator)
        self.head = _linear(cfg.hidden_dim, cfg.n_assets, device, generator)

    def forward(self, regime_seq: torch.Tensor) -> torch.Tensor:
        out, _ = self.lstm(_as_seq(regime_seq, self.cfg.K))
        return torch.softmax(self.head(out[:, -1]), dim=-1)
