"""Regime-conditional Monte Carlo of a portfolio (counterpart of
vqvaehmm_tpu/backtest/montecarlo.py; reference: backtest.py:138-292).

The simulation is split in two.  `monte_carlo_draws` takes every random
number a run needs from a torch.Generator up front: each path's first
regime, and for each day a switch uniform, a new regime and A standard
normals.  `simulate_paths` then runs the days on those draws: vectorised
over the paths, a Python loop over the days.  The JAX package draws from
jax.random keys inside its scan, so the two packages' paths differ from
one seed; handed the same draws, they agree.

`regime_statistics`, `analyze_monte_carlo` and `plot_monte_carlo` are the
JAX package's numpy and matplotlib code, copied (the port imports nothing
of it); they take tensors on any device as well as arrays.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def regime_statistics(returns, regimes, K: int, jitter: float = 1e-8
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The mean and covariance of the asset returns in each regime
    (reference: backtest.py:156-163).

    returns: (T, A); regimes: (T,) int labels.  A regime with too few
    days to estimate (<= A + 1) gets zero mean and jitter * I, with a
    warning: simulated days in it return about nothing and understate the
    risk."""
    returns, regimes = _numpy(returns), _numpy(regimes)
    T, A = returns.shape
    means = np.zeros((K, A))
    covs = np.tile(np.eye(A) * jitter, (K, 1, 1))
    for k in range(K):
        m = regimes == k
        if m.sum() > A + 1:
            means[k] = returns[m].mean(axis=0)
            covs[k] = np.cov(returns[m].T) + np.eye(A) * jitter
        else:
            warnings.warn(
                f"regime {k} has only {int(m.sum())} samples "
                f"(need > {A + 1}); using zero-mean/jitter covariance — "
                "MC days in this regime will be ~flat", stacklevel=2)
    return means, covs


def monte_carlo_draws(generator: torch.Generator, K: int, A: int,
                      n_sim: int, n_days: int,
                      p0: Optional[np.ndarray] = None
                      ) -> Dict[str, torch.Tensor]:
    """Every random number of a run, on the generator's device: z0 (n_sim,)
    the first regime, from p0 (uniform where None); u_switch (n_sim,
    n_days) uniforms; z_new (n_sim, n_days) regimes drawn uniformly; eps
    (n_sim, n_days, A) standard normals."""
    gdev = generator.device
    probs = torch.as_tensor(np.full(K, 1.0 / K) if p0 is None
                            else np.asarray(p0), dtype=torch.float32,
                            device=gdev)
    return {
        "z0": torch.multinomial(probs, n_sim, replacement=True,
                                generator=generator),
        "u_switch": torch.rand((n_sim, n_days), generator=generator,
                               device=gdev),
        "z_new": torch.randint(0, K, (n_sim, n_days), generator=generator,
                               device=gdev),
        "eps": torch.randn((n_sim, n_days, A), generator=generator,
                           device=gdev),
    }


def simulate_paths(regime_weights: torch.Tensor, means: torch.Tensor,
                   chols: torch.Tensor, z0: torch.Tensor,
                   u_switch: torch.Tensor, z_new: torch.Tensor,
                   eps: torch.Tensor, rebalance_every: int = 5,
                   switch_prob: float = 0.05, tx_cost: float = 0.001,
                   initial_value: float = 1.0) -> Dict:
    """The days of every path on given draws, in the reference's order
    (backtest.py:165-215; the JAX package's montecarlo.py:59-73, 91-108):

    * the weights start at zero, so day 0 pays for setting up the
      portfolio;
    * on a rebalance day (day % rebalance_every == 0) the weights become
      those of the regime before any switch, and the cost debits the value
      before the day's return compounds;
    * then, on rebalance days only, the regime switches where
      u_switch < switch_prob, to z_new;
    * the day's return is drawn from the regime after the switch:
      means[z] + chols[z] @ eps;
    * daily_returns = value / previous value - 1, costs included.

    regime_weights (K, A), means (K, A), chols (K, A, A); the draws as
    monte_carlo_draws makes them.  Everything runs on regime_weights'
    device, in float32."""
    dev = regime_weights.device
    f32 = dict(dtype=torch.float32, device=dev)
    regime_weights, means, chols = (t.to(**f32) for t in
                                    (regime_weights, means, chols))
    z = z0.to(device=dev, dtype=torch.long)
    u_switch, eps = u_switch.to(**f32), eps.to(**f32)
    z_new = z_new.to(device=dev, dtype=torch.long)
    n_sim, n_days = u_switch.shape
    value = torch.full((n_sim,), float(initial_value), **f32)
    w = torch.zeros((n_sim, regime_weights.shape[1]), **f32)
    daily = []
    for day in range(n_days):
        prev = value
        if day % rebalance_every == 0:
            w_target = regime_weights[z]
            cost_frac = tx_cost * (w_target - w).abs().sum(-1)
            value = value * (1.0 - cost_frac)
            w = w_target
            z = torch.where(u_switch[:, day] < switch_prob, z_new[:, day], z)
        r = means[z] + torch.einsum("nij,nj->ni", chols[z], eps[:, day])
        value = value * (1.0 + (w * r).sum(-1))
        daily.append(value / prev - 1.0)
    return {"final_values": value,
            "daily_returns": torch.stack(daily, dim=1) if daily
            else torch.zeros((n_sim, 0), **f32),
            "initial_value": initial_value}


def monte_carlo_simulation(weight_fn: Callable, means, covs,
                           generator: torch.Generator, n_sim: int = 1000,
                           n_days: int = 252, rebalance_every: int = 5,
                           switch_prob: float = 0.05, tx_cost: float = 0.001,
                           initial_value: float = 1.0,
                           p0: Optional[np.ndarray] = None,
                           device="cuda") -> Dict:
    """n_sim paths of n_days on `device` (the card unless the caller asks
    for the CPU): the draws from `generator` (monte_carlo_draws), then
    simulate_paths.

    weight_fn: a one-hot regime (K,) tensor -> portfolio weights (A,),
    called once a regime under torch.no_grad() (a head must be in eval()
    mode).  The Cholesky factors of covs are taken in float64 and then
    rounded to float32, as in the JAX package.  daily_returns are
    value-change ratios, so cumprod(1 + daily_returns) is each path's
    equity."""
    dev = resolve_device(device)
    means = torch.as_tensor(np.asarray(means), dtype=torch.float32,
                            device=dev)
    K, A = means.shape
    chols = torch.as_tensor(np.linalg.cholesky(np.asarray(covs)),
                            dtype=torch.float32, device=dev)
    eye = torch.eye(K, dtype=torch.float32, device=dev)
    with torch.no_grad():
        regime_weights = torch.stack([weight_fn(eye[k]) for k in range(K)])
    draws = monte_carlo_draws(generator, K, A, n_sim, n_days, p0)
    return simulate_paths(regime_weights, means, chols, **draws,
                          rebalance_every=rebalance_every,
                          switch_prob=switch_prob, tx_cost=tx_cost,
                          initial_value=initial_value)


def analyze_monte_carlo(results: Dict, initial_value: Optional[float] = None
                        ) -> Dict[str, float]:
    """Percentiles, P(profit) and the expected Sharpe: the reference's
    annualised total-return Sharpe across paths (backtest.py:243-247), not
    a mean of each path's daily Sharpe.  initial_value defaults to the one
    recorded in `results`."""
    finals = _numpy(results["final_values"])
    rets = _numpy(results["daily_returns"])
    if initial_value is None:
        initial_value = float(results.get("initial_value", 1.0))
    total_returns = finals / initial_value - 1.0
    n_years = max(rets.shape[1], 1) / 252.0
    expected_sharpe = ((total_returns.mean() / n_years)
                       / (total_returns.std() / np.sqrt(n_years) + 1e-8))
    pct = np.percentile(total_returns, [5, 25, 50, 75, 95])
    return {
        "mean_return": float(total_returns.mean()),
        "median_return": float(pct[2]),
        "p5": float(pct[0]), "p25": float(pct[1]),
        "p75": float(pct[3]), "p95": float(pct[4]),
        "prob_profit": float((total_returns > 0).mean()),
        "expected_sharpe": float(expected_sharpe),
        "worst_case": float(total_returns.min()),
        "best_case": float(total_returns.max()),
    }


def plot_monte_carlo(results, path: Optional[str] = None):
    """The final values' histogram and sample equity paths (reference:
    backtest.py:252-292); None where matplotlib is missing."""
    try:
        import sys

        import matplotlib
        if "matplotlib.pyplot" not in sys.modules:
            # do not switch an interactive session's backend under it
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    finals = _numpy(results["final_values"])
    rets = _numpy(results["daily_returns"])
    equity = np.cumprod(1 + rets, axis=1)
    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    axes[0].hist(finals, bins=50, alpha=0.7)
    axes[0].set_title("Final Value Distribution")
    axes[0].grid(True)
    for i in range(min(100, equity.shape[0])):
        axes[1].plot(equity[i], alpha=0.1, color="tab:blue")
    axes[1].plot(np.median(equity, axis=0), color="tab:red", lw=2,
                 label="median")
    axes[1].set_title("Simulated Equity Paths")
    axes[1].legend()
    axes[1].grid(True)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        # a figure saved to disk is closed, so repeated calls do not keep
        # figures holding whole path arrays open
        plt.close(fig)
    return fig
