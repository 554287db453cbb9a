"""Delta hedgers that read regime posteriors (counterpart of
vqvaehmm_tpu/models/hedging.py; reference: delta_hedger.py:7-183), as
nn.Modules.  Parameter names are the JAX pytree's paths with `.` for `/`
(`delta1.weight`, ...), and the LSTM's are nn.LSTM's
(data/checkpoint.py::zoo_params_from_numpy carries them across).

A deviation kept from the JAX package (its hedging.py:4-10): the
reference's DynamicDeltaHedger applies Dropout(0.1) while it trains; here,
as in JAX, there is no dropout, in training either.  Inference matches the
reference; a trained hedger may differ by the missing regularisation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import nn as ops
from ..ops.rnn import make_lstm
from .portfolio import HeadConfig, _as_seq, _last_step


def _linear(in_dim: int, out_dim: int, device,
            generator: Optional[torch.Generator]) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim, device=device)
    ops.init_linear_(lin, generator)
    return lin


class RegimeDeltaHedger(nn.Module):
    """A delta MLP on [q, position], gated by a sigmoid uncertainty net:
    hedge = -delta * uncertainty * position (reference :7-34)."""

    def __init__(self, cfg: HeadConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.delta1 = _linear(c.K + c.n_assets, c.hidden_dim, device,
                              generator)
        self.delta2 = _linear(c.hidden_dim, c.hidden_dim, device, generator)
        self.delta3 = _linear(c.hidden_dim, c.n_assets, device, generator)
        self.unc1 = _linear(c.K, c.hidden_dim // 2, device, generator)
        self.unc2 = _linear(c.hidden_dim // 2, 1, device, generator)

    def forward(self, regime_probs, spot_prices, portfolio_pos
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        q = _last_step(regime_probs)
        feat = torch.cat([q, portfolio_pos], dim=-1)
        h = torch.relu(self.delta1(feat))
        h = torch.relu(self.delta2(h))
        delta = torch.tanh(self.delta3(h))
        u = torch.relu(self.unc1(q))
        uncertainty = torch.sigmoid(self.unc2(u))
        hedge = -(delta * uncertainty) * portfolio_pos
        return hedge, delta


class DynamicDeltaHedger(nn.Module):
    """Delta and optional gamma nets on [q, position, spot(, gamma)]
    (reference :37-76); no dropout (module docstring)."""

    def __init__(self, cfg: HeadConfig, use_gamma: bool = True, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.use_gamma = use_gamma
        c = cfg
        d = c.K + c.n_assets * 2 + (c.n_assets if use_gamma else 0)
        self.delta1 = _linear(d, c.hidden_dim, device, generator)
        self.delta2 = _linear(c.hidden_dim, c.hidden_dim, device, generator)
        self.delta3 = _linear(c.hidden_dim, c.n_assets, device, generator)
        if use_gamma:
            self.gamma1 = _linear(d, c.hidden_dim, device, generator)
            self.gamma2 = _linear(c.hidden_dim, c.n_assets, device,
                                  generator)

    def forward(self, regime_probs, spot_prices, portfolio_pos,
                gamma: Optional[torch.Tensor] = None):
        q = _last_step(regime_probs)
        feats = [q, portfolio_pos, spot_prices]
        if self.use_gamma:
            if gamma is None:
                raise ValueError(
                    "DynamicDeltaHedger(use_gamma=True) requires gamma=; "
                    "construct with use_gamma=False to hedge without it")
            feats.append(gamma)
        x = torch.cat(feats, dim=-1)
        h = torch.relu(self.delta1(x))
        h = torch.relu(self.delta2(h))
        delta = self.delta3(h)
        if self.use_gamma:
            g = torch.relu(self.gamma1(x))
            total = delta + 0.5 * self.gamma2(g) * spot_prices
        else:
            total = delta
        return total, delta


class LSTMDeltaHedger(nn.Module):
    """An LSTM over [regime path, price path] -> tanh hedge ratios
    (reference :79-92)."""

    def __init__(self, cfg: HeadConfig, num_layers: int = 2,
                 lookback: int = 10, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.num_layers = num_layers
        self.lookback = lookback
        self.lstm = make_lstm(cfg.K + cfg.n_assets, cfg.hidden_dim,
                              num_layers, device, generator)
        self.head = _linear(cfg.hidden_dim, cfg.n_assets, device, generator)

    def forward(self, regime_seq, price_seq) -> torch.Tensor:
        seq = _as_seq(regime_seq, self.cfg.K)                   # (B, T, K)
        T = seq.shape[1]
        # price_seq is channels-first (B, C, T), as train_delta_hedger
        # passes x, or time-major (B, T, C); a square C == T input is read
        # channels-first, the caller contract of the JAX package
        if price_seq.shape[1] != T or price_seq.shape[2] == T:
            price_seq = price_seq.transpose(1, 2)
        out, _ = self.lstm(torch.cat([seq, price_seq], dim=-1))
        return torch.tanh(self.head(out[:, -1]))


class TransactionCostAwareHedger(nn.Module):
    """A hedge net and a learned threshold: a position is rehedged only
    where it is more than threshold * 0.1 off; returns (new hedge, cost)
    (reference :120-152)."""

    def __init__(self, cfg: HeadConfig, tx_cost: float = 0.001, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.tx_cost = tx_cost
        c = cfg
        self.hedge1 = _linear(c.K + c.n_assets * 2, c.hidden_dim, device,
                              generator)
        self.hedge2 = _linear(c.hidden_dim, c.n_assets, device, generator)
        self.thresh1 = _linear(c.K, c.hidden_dim // 2, device, generator)
        self.thresh2 = _linear(c.hidden_dim // 2, 1, device, generator)

    def forward(self, regime_probs, current_hedge, target_delta,
                spot_prices):
        q = _last_step(regime_probs)
        feat = torch.cat([q, current_hedge, spot_prices], dim=-1)
        optimal = self.hedge2(torch.relu(self.hedge1(feat)))
        t = torch.relu(self.thresh1(q))
        threshold = torch.sigmoid(self.thresh2(t)) * 0.1
        deviation = (optimal - current_hedge).abs()
        rehedge = (deviation > threshold).to(optimal.dtype)
        new_hedge = current_hedge + (optimal - current_hedge) * rehedge
        trade = (new_hedge - current_hedge).abs()
        cost = self.tx_cost * trade * spot_prices
        return new_hedge, cost.sum(dim=-1)


class TransitionAwareHedger(nn.Module):
    """q rolled `lookahead` steps forward through the last transition
    matrix; the hedge reads the whole rolled path (reference :155-183)."""

    def __init__(self, cfg: HeadConfig, lookahead: int = 5, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.lookahead = lookahead
        c = cfg
        d = c.K * (lookahead + 1) + c.n_assets
        self.fc1 = _linear(d, c.hidden_dim, device, generator)
        self.fc2 = _linear(c.hidden_dim, c.hidden_dim, device, generator)
        self.fc3 = _linear(c.hidden_dim, c.n_assets, device, generator)

    def forward(self, regime_probs, trans_matrix, spot_prices):
        q = _last_step(regime_probs)
        A_last = trans_matrix[:, -1, :, :]                      # (B, K, K)
        path = [q]
        for _ in range(self.lookahead):
            path.append(torch.einsum("bk,bkj->bj", path[-1], A_last))
        feat = torch.cat(path + [spot_prices], dim=-1)
        h = torch.relu(self.fc1(feat))
        h = torch.relu(self.fc2(h))
        return torch.tanh(self.fc3(h))
