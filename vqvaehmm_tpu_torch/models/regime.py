"""Regime-analysis models and utilities (counterpart of
vqvaehmm_tpu/models/regime.py).

Models: RegimeChangeDetector, ForwardTransitionPredictor,
RegimePersistenceModel, TemperatureScaling, RegimeFactorModel (each an
nn.Module with an explicit `device` and a `generator` for its initial
weights; data/checkpoint.py::zoo_params_from_numpy carries the JAX
package's parameters across).  Functions: calibrate_probabilities (numpy
on the host), estimate_regime_covariance, confidence_based_sizing,
optimize_rebalancing_frequency, optimize_leverage.

The per-regime loops of the reference are einsums, as in JAX.  The two
LSTM models read a 3-D input as (B, T, K) and transpose only a (B, K, T)
input whose T differs from K (`_as_seq_unambiguous`): a square
(B, K, K) input passes through untransposed, unlike the heads' as_seq.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.rnn import make_lstm
from .portfolio import _last_step, _linear


def _as_seq_unambiguous(q: torch.Tensor, K: int) -> torch.Tensor:
    """(B, K, T) -> (B, T, K) only where the layouts can be told apart."""
    if q.dim() == 3 and q.shape[1] == K and q.shape[2] != K:
        return q.transpose(1, 2)
    return q


class RegimeChangeDetector(nn.Module):
    """A 2-layer LSTM over the regime path -> sigmoid P(regime change)
    (parameters lstm.*, fc.*)."""

    def __init__(self, K: int, hidden_dim: int = 64, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K, self.hidden_dim = K, hidden_dim
        self.lstm = make_lstm(K, hidden_dim, 2, device, generator)
        self.fc = _linear(hidden_dim, 1, device, generator)

    def forward(self, regime_probs_seq: torch.Tensor) -> torch.Tensor:
        out, _ = self.lstm(_as_seq_unambiguous(regime_probs_seq, self.K))
        return torch.sigmoid(self.fc(out[:, -1, :]))


class ForwardTransitionPredictor(nn.Module):
    """A 2-layer LSTM -> (B, n_steps, K) softmax forecast of the regimes
    of the next n_steps steps (parameters lstm.*, fc.*)."""

    def __init__(self, K: int, n_steps: int = 5, hidden_dim: int = 64,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K, self.n_steps, self.hidden_dim = K, n_steps, hidden_dim
        self.lstm = make_lstm(K, hidden_dim, 2, device, generator)
        self.fc = _linear(hidden_dim, K * n_steps, device, generator)

    def forward(self, regime_probs_seq: torch.Tensor) -> torch.Tensor:
        out, _ = self.lstm(_as_seq_unambiguous(regime_probs_seq, self.K))
        logits = self.fc(out[:, -1, :]).reshape(-1, self.n_steps, self.K)
        return torch.softmax(logits, dim=-1)


class RegimePersistenceModel(nn.Module):
    """Expected duration: softplus MLP of q plus q weighted by the diagonal
    of the transition matrix (parameters fc1.*, fc2.*)."""

    def __init__(self, K: int, hidden_dim: int = 32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K, self.hidden_dim = K, hidden_dim
        self.fc1 = _linear(K, hidden_dim, device, generator)
        self.fc2 = _linear(hidden_dim, 1, device, generator)

    def forward(self, regime_probs: torch.Tensor,
                transition_matrix: torch.Tensor) -> torch.Tensor:
        q = _last_step(regime_probs)
        self_trans = torch.diagonal(transition_matrix, dim1=-2, dim2=-1)
        weighted = (q * self_trans).sum(-1, keepdim=True)
        h = torch.relu(self.fc1(q))
        return nn.functional.softplus(self.fc2(h)) + weighted


class TemperatureScaling(nn.Module):
    """One learned temperature dividing the regime logits (parameter
    temperature (1,), initially 1)."""

    def __init__(self, device=None):
        super().__init__()
        self.temperature = nn.Parameter(torch.ones(1, device=device))

    def forward(self, logits: torch.Tensor) -> torch.Tensor:
        return logits / self.temperature

    def calibrate(self, logits, labels, lr: float = 0.05,
                  max_iter: int = 200) -> Tuple[Dict[str, torch.Tensor],
                                                float]:
        """Fit the temperature to (logits (N, K), integer labels (N,)) by
        max_iter steps of Adam (optax's defaults) on the log-temperature,
        minimising the mean negative log-likelihood.  Sets the parameter
        and returns ({"temperature": t}, float(t))."""
        dev = self.temperature.device
        logits = torch.as_tensor(logits, dtype=torch.float32, device=dev)
        labels = torch.as_tensor(labels, device=dev).long()
        log_t = torch.log(self.temperature.detach()).clone() \
            .requires_grad_(True)
        opt = torch.optim.Adam([log_t], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for _ in range(max_iter):
            lp = torch.log_softmax(logits / torch.exp(log_t), dim=-1)
            loss = -lp.gather(1, labels[:, None]).mean()
            log_t.grad, = torch.autograd.grad(loss, [log_t])
            opt.step()
        with torch.no_grad():
            self.temperature.copy_(torch.exp(log_t))
        t = self.temperature.detach().clone()
        return {"temperature": t}, float(t[0])


class RegimeFactorModel(nn.Module):
    """Per-regime factor loadings (K, A, F) and specific risks (K, A) ->
    the probability-weighted covariance (B, A, A)."""

    def __init__(self, K: int, n_assets: int, n_factors: int = 5,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.K, self.n_assets, self.n_factors = K, n_assets, n_factors
        draw = torch.empty((K, n_assets, n_factors)).normal_(
            generator=generator)
        self.factor_loadings = nn.Parameter(draw.to(device))
        self.specific_risk = nn.Parameter(torch.ones((K, n_assets),
                                                     device=device))

    def get_covariance(self, regime_probs: torch.Tensor) -> torch.Tensor:
        q = _last_step(regime_probs)                       # (B, K)
        F = self.factor_loadings
        cov_k = torch.einsum("kaf,kcf->kac", F, F) \
            + torch.diag_embed(self.specific_risk ** 2)
        return torch.einsum("bk,kac->bac", q, cov_k)


# ---------------------------------------------------------------------------
# Functions
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def calibrate_probabilities(regime_probs, true_regimes,
                            n_bins: int = 10) -> List[Tuple[float, float]]:
    """Reliability-diagram bins on the host: (mean confidence, accuracy)
    of each non-empty bin of the max probability."""
    p = _host(regime_probs)
    t = _host(true_regimes)
    max_probs = p.max(axis=-1)
    pred = p.argmax(axis=-1)
    edges = np.linspace(0, 1, n_bins + 1)
    out = []
    for i in range(n_bins):
        m = (max_probs >= edges[i]) & (max_probs < edges[i + 1])
        if m.sum() > 0:
            out.append((float(max_probs[m].mean()),
                        float((pred[m] == t[m]).mean())))
    return out


def estimate_regime_covariance(returns: torch.Tensor,
                               regime_probs: torch.Tensor,
                               K: int) -> torch.Tensor:
    """Each regime's probability-weighted covariance of returns (B, T, A)
    -> (B, K, A, A).  regime_probs is (B, K, T) where its dim 1 is K, else
    (B, T, K); the weight sums are floored at 1e-8."""
    rp = regime_probs.transpose(1, 2) if regime_probs.shape[1] == K \
        else regime_probs                                  # (B, T, K)
    w = rp[:, :, :, None]                                  # (B, T, K, 1)
    wr = returns[:, :, None, :] * w                        # (B, T, K, A)
    wsum = torch.clamp(w.sum(dim=1), min=1e-8)             # (B, K, 1)
    mean = wr.sum(dim=1) / wsum                            # (B, K, A)
    centered = wr - mean[:, None]
    cov = torch.einsum("btka,btkc->bkac", centered, centered * w)
    return cov / wsum[:, :, :, None]


def confidence_based_sizing(weights: torch.Tensor,
                            regime_probs: torch.Tensor,
                            min_confidence: float = 0.5,
                            max_scale: float = 1.5) -> torch.Tensor:
    """Scale the weights by the max probability's confidence above
    min_confidence, up to max_scale, and renormalise."""
    q = _last_step(regime_probs)
    conf = q.max(dim=-1).values
    norm = torch.clamp(conf - min_confidence, min=0.0) / (1 - min_confidence)
    scale = 1.0 + (max_scale - 1.0) * norm
    scaled = weights * scale[:, None]
    return scaled / scaled.sum(-1, keepdim=True)


def optimize_rebalancing_frequency(regime_probs, transition_probs,
                                   returns: torch.Tensor,
                                   transaction_cost: float = 0.001,
                                   max_freq: int = 21) -> torch.Tensor:
    """sqrt(c / 2 sigma) * 252, clipped to [1, max_freq], as an int32
    scalar; sigma is the mean over rows of the ddof=1 std of returns
    along dim 1."""
    vol = torch.std(returns, dim=1, correction=1).mean()
    freq = torch.sqrt(transaction_cost / (2 * vol)) * 252
    return torch.clamp(freq, 1, max_freq).to(torch.int32)


def optimize_leverage(weights: torch.Tensor, returns: torch.Tensor,
                      max_leverage: float = 2.0,
                      target_vol: float = 0.15) -> torch.Tensor:
    """The weights times target_vol over the portfolio's ddof=1 return
    volatility, capped at max_leverage."""
    pr = (weights[:, None, :] * returns).sum(-1)
    vol = torch.std(pr, dim=1, correction=1)
    mult = torch.clamp(target_vol / vol, max=max_leverage)
    return weights * mult[:, None]
