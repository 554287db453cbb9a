"""Portfolio and hedging losses (counterpart of
vqvaehmm_tpu/losses/portfolio.py), plain functions on tensors.

Shapes follow the reference: weights (B, n_assets), returns (B, T,
n_assets), regime probabilities (B, K) or (B, K, T).  Standard deviations
and variances are unbiased (ddof 1, torch's default), as the JAX package
computes them.  Every function runs on the device of its inputs and is
differentiable where the JAX one is.

On the card, `_max_drawdown`'s gradient reaches the running maximum
through `torch.cummax`, whose backward adds into a zero tensor with
atomics; only the step that sets the drawdown carries a non-zero term
(the max over time selects one step a row), so the sum does not depend
on the order of those additions and a run repeats bit for bit.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..ops.nn import as_seq


def _std(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Unbiased (ddof 1) standard deviation."""
    return torch.std(x, dim=dim)


def _portfolio_returns(weights: torch.Tensor,
                       returns: torch.Tensor) -> torch.Tensor:
    """(B, A), (B, T, A) -> (B, T) returns of the portfolio a step."""
    return (weights[:, None, :] * returns).sum(-1)


def sharpe_loss(weights, returns, rf: float = 0.0) -> torch.Tensor:
    """-mean Sharpe (reference: VQ_VAE_HMM_fixed.py:198-202)."""
    pr = _portfolio_returns(weights, returns)
    mu = pr.mean(dim=1)
    sigma = torch.clamp(_std(pr, 1), min=1e-8)
    return -((mu - rf) / sigma).mean()


def sortino_loss(weights, returns, risk_free_rate: float = 0.0,
                 target_return: float = 0.0) -> torch.Tensor:
    """Sharpe over the downside deviation (reference:
    loss_functions.py:50-56)."""
    pr = _portfolio_returns(weights, returns)
    mu = pr.mean(dim=1)
    downside = torch.clamp(pr - target_return, max=0.0)
    dstd = torch.clamp(torch.sqrt((downside ** 2).mean(dim=1)), min=1e-8)
    return -((mu - risk_free_rate) / dstd).mean()


def _max_drawdown(pr: torch.Tensor) -> torch.Tensor:
    """(B, T) returns -> (B,) largest drawdown of the cumulative-sum curve
    (reference: loss_functions.py:32-35)."""
    cum = torch.cumsum(pr, dim=1)
    running_max = torch.cummax(cum, dim=1).values
    return (running_max - cum).max(dim=1).values


def calmar_loss(weights, returns) -> torch.Tensor:
    """-mean(mu / max drawdown) (reference: loss_functions.py:59-67)."""
    pr = _portfolio_returns(weights, returns)
    mu = pr.mean(dim=1)
    mdd = torch.clamp(_max_drawdown(pr), min=1e-8)
    return -(mu / mdd).mean()


def portfolio_loss(weights, returns, prev_weights=None, regime_probs=None,
                   covariance=None, risk_free_rate: float = 0.0,
                   transaction_cost: float = 0.001, max_weight: float = 0.3,
                   max_leverage: float = 1.0, lambda_turnover: float = 0.1,
                   lambda_drawdown: float = 0.1,
                   lambda_cvar: float = 0.1) -> torch.Tensor:
    """-Sharpe + turnover + position and leverage penalties + max drawdown
    + CVaR at 5% (reference: loss_functions.py:6-47).

    regime_probs and covariance are accepted and unused, as in the
    reference and the JAX package; the head trainers pass q through."""
    T = returns.shape[1]
    pr = _portfolio_returns(weights, returns)

    mu = pr.mean(dim=1)
    sigma = torch.clamp(_std(pr, 1), min=1e-8)
    sharpe = (mu - risk_free_rate) / sigma

    turnover_loss = 0.0
    if prev_weights is not None:
        turnover = (weights - prev_weights).abs().sum(-1)
        turnover_loss = transaction_cost * turnover.mean()

    position_penalty = torch.relu(weights - max_weight).sum(-1).mean()
    leverage_penalty = torch.relu(weights.sum(-1) - max_leverage).mean()
    max_dd = _max_drawdown(pr).mean()

    # CVaR at 5%: the mean of the worst int(0.05 T) returns of each row
    var_idx = int(0.05 * T)
    if var_idx > 0:
        cvar = -torch.sort(pr, dim=1).values[:, :var_idx].mean()
    else:
        cvar = torch.zeros((), dtype=torch.float32, device=pr.device)

    return (-sharpe.mean() + lambda_turnover * turnover_loss
            + position_penalty + leverage_penalty
            + lambda_drawdown * max_dd + lambda_cvar * cvar)


def risk_parity_loss(weights, returns, covariance=None) -> torch.Tensor:
    """Squared deviation of the risk contributions from their mean
    (reference: loss_functions.py:70-86)."""
    if covariance is None:
        T = returns.shape[1]
        centered = returns - returns.mean(dim=1, keepdim=True)
        covariance = torch.einsum("bta,btc->bac", centered, centered) / T
    port_var = torch.einsum("ba,bac,bc->b", weights, covariance, weights)
    port_std = torch.sqrt(torch.clamp(port_var, min=1e-8))
    marginal = torch.einsum("bac,bc->ba", covariance, weights)
    contrib = weights * marginal / port_std[:, None]
    target = contrib.mean(-1, keepdim=True)
    return ((contrib - target) ** 2).sum(-1).mean()


def regime_conditional_loss(weights, returns, regime_probs,
                            K: int) -> torch.Tensor:
    """Per-regime probability-weighted Sharpe, weighted by the last step's
    regime probabilities (reference: loss_functions.py:89-109)."""
    T = returns.shape[1]
    rp = as_seq(regime_probs, K)                                # (B, T, K)
    w_ret = returns[:, :, None, :] * rp[:, :, :, None]          # (B,T,K,A)
    centered = w_ret - w_ret.mean(dim=1, keepdim=True)
    cov = torch.einsum("btka,btkc->bkac", centered, centered) / T
    port_var = torch.einsum("ba,bkac,bc->bk", weights, cov, weights)
    pr = torch.einsum("ba,btka->btk", weights, w_ret)
    mu = pr.mean(dim=1)                                         # (B, K)
    sharpe_k = mu / torch.sqrt(torch.clamp(port_var, min=1e-8))
    weight_k = rp[:, -1, :].mean(dim=0)                         # (K,)
    return -(sharpe_k.mean(dim=0) * weight_k).sum()


def adversarial_portfolio_loss(model_fn: Callable, regime_probs, returns,
                               epsilon: float = 0.01) -> torch.Tensor:
    """FGSM on the regime probabilities (reference:
    loss_functions.py:112-125): the probabilities moved by epsilon along
    the sign of the loss's gradient, renormalised by a softmax over dim 1,
    and the loss of the weights the model gives there.

    model_fn: regime probabilities -> weights (a head, or a closure over
    one).  The gradient with respect to the probabilities is taken with
    create_graph=True, so the returned loss is differentiable in the
    model's parameters as JAX's is."""
    rp = regime_probs if regime_probs.requires_grad \
        else regime_probs.detach().requires_grad_(True)
    inner = -_portfolio_returns(model_fn(rp), returns).mean()
    grad, = torch.autograd.grad(inner, rp, create_graph=True)
    perturbed = torch.softmax(regime_probs + epsilon * torch.sign(grad),
                              dim=1)
    return -_portfolio_returns(model_fn(perturbed), returns).mean()


def transition_aware_loss(weights, returns, regime_probs, transition_probs,
                          rebalance_cost: float = 0.001,
                          lookahead: int = 5) -> torch.Tensor:
    """Sharpe less the cost of the probability that the regime changes
    within `lookahead` steps (reference: loss_functions.py:128-147).

    regime_probs is (B, K, T), or (B, T, K) told apart by returns' T;
    transition_probs is the (B, T, K, K) stack, whose last matrix is
    applied `lookahead` times."""
    T = returns.shape[1]
    if regime_probs.dim() == 3 and regime_probs.shape[2] != T \
            and regime_probs.shape[1] == T:
        regime_probs = regime_probs.transpose(1, 2)
    current = regime_probs[:, :, -1]                            # (B, K)
    A_last = transition_probs[:, -1, :, :]                      # (B, K, K)
    future = current
    for _ in range(lookahead):
        future = torch.einsum("bk,bkj->bj", future, A_last)
    change_prob = 1.0 - (current * future).sum(-1)

    pr = _portfolio_returns(weights, returns)
    mu = pr.mean(dim=1)
    sigma = torch.clamp(_std(pr, 1), min=1e-8)
    sharpe = mu / sigma
    return -(sharpe - rebalance_cost * change_prob).mean()


def regime_aware_sharpe_loss(weights, returns, regime_probs, trans_probs,
                             rf: float = 0.0) -> torch.Tensor:
    """Sharpe of the returns weighted by the regime's confidence, less a
    penalty on short expected durations (reference:
    VQ_VAE_HMM_fixed.py:214-228).

    regime_probs is the posterior path (B, T, K), or (B, K, T) told apart
    by returns' T; trans_probs is (B, K, K) or the per-step (B, T, K, K)
    stack, of which the last step's matrix is used."""
    pr = _portfolio_returns(weights, returns)
    T = returns.shape[1]
    if regime_probs.dim() == 3 and regime_probs.shape[1] != T \
            and regime_probs.shape[2] == T:
        regime_probs = regime_probs.transpose(1, 2)
    confidence = regime_probs.max(dim=-1).values
    weighted = pr * confidence
    if trans_probs.dim() == 4:
        trans_probs = trans_probs[:, -1]
    diag = torch.diagonal(trans_probs, dim1=-2, dim2=-1).mean(-1)
    duration = 1.0 / (1.0 - diag + 1e-8)
    penalty = 0.01 / torch.clamp(duration, min=1.0)
    mu = weighted.mean(dim=1)
    sigma = torch.clamp(_std(weighted, 1), min=1e-8)
    sharpe = (mu - rf) / sigma
    return -(sharpe.mean() - penalty.mean())


# ---------------------------------------------------------------------------
# Hedging losses and analytics (reference: delta_hedger.py:95-200)
# ---------------------------------------------------------------------------


def delta_hedge_loss(hedge_pos, spot_ret, futures_ret, tx_costs=None,
                     lambda_cost: float = 0.1) -> torch.Tensor:
    """var(spot + h * futures) over time + a cost penalty (reference
    :186-194)."""
    hedged = spot_ret + hedge_pos[:, None, :] * futures_ret
    hedge_var = torch.var(hedged, dim=1).mean()
    cost = tx_costs.mean() if tx_costs is not None else 0.0
    return hedge_var + lambda_cost * cost


def minimum_variance_hedge_ratio(spot_ret, futures_ret, regime_probs=None,
                                 K: Optional[int] = None) -> torch.Tensor:
    """Minimum-variance hedge ratio (reference :95-117), weighted by
    regime where regime_probs and K are given."""
    if regime_probs is not None and K is not None:
        rp = as_seq(regime_probs, K)                            # (B, T, K)
        wsum = torch.clamp(rp.sum(dim=1), min=1e-8)             # (B, K)
        spot_w = spot_ret[:, :, None, :] * rp[:, :, :, None]    # (B,T,K,A)
        fut_w = futures_ret[:, :, None, :] * rp[:, :, :, None]
        cov = (spot_w * fut_w).sum(dim=1) / wsum[:, :, None]
        var = (fut_w ** 2).sum(dim=1) / wsum[:, :, None]
        ratios = cov / torch.clamp(var, min=1e-8)               # (B, K, A)
        return (ratios * rp[:, -1, :, None]).sum(dim=1)
    cov = (spot_ret * futures_ret).mean(dim=1)
    var = torch.clamp((futures_ret ** 2).mean(dim=1), min=1e-8)
    return cov / var


def optimal_hedge_frequency(spot_vol, tx_cost, regime_persistence):
    """Leland (1985) rehedging frequency, scaled down by the regime's
    persistence (reference :197-200).  Numbers or tensors."""
    spot_vol = torch.as_tensor(spot_vol, dtype=torch.float32)
    base = torch.sqrt(8.0 * torch.as_tensor(tx_cost, dtype=torch.float32)
                      / (math.pi * torch.clamp(spot_vol ** 2, min=1e-12)))
    return base / torch.clamp(torch.as_tensor(regime_persistence,
                                              dtype=torch.float32), min=1.0)
