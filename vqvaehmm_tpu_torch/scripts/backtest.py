"""The GMM-stack backtest runner (counterpart of scripts/backtest.py,
reference backtest.py:1-390): the GMM stack (train/gmm_pipeline.py:
the detector's float64 EM and the per-regime head) trained on the
returns, the regime-conditional statistics of its decode, Monte Carlo
paths of the head's regime weights with rebalancing costs (on --device),
their percentile analytics and plot, and the equal-weight benchmark.  On
market data where load_portfolio_data finds a panel
(VQHMM_MARKET_FIXTURE), synthetic returns otherwise or with --synthetic.
Writes <outdir>/backtest_summary.json and monte_carlo_results.png (where
matplotlib is present).

    python -m vqvaehmm_tpu_torch.scripts.backtest [--synthetic]
        [--n-sim 1000] [--n-days 252] [--device cuda]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..backtest.montecarlo import (analyze_monte_carlo,
                                   monte_carlo_simulation, plot_monte_carlo,
                                   regime_statistics)
from ..core.device import resolve_device
from ..models.gmm import prepare_regime_features
from ..train.gmm_pipeline import benchmark_equal_weight, train_improved_system
from ._common import device_record, parser, write_json

MC_SEED = 0


def synthetic_returns(T=800, A=6):
    rng = np.random.default_rng(0)
    return rng.normal(4e-4, 0.01, size=(T, A)).astype(np.float32)


def main(argv=None) -> int:
    ap = parser("backtest", "The GMM-stack backtest: Monte Carlo paths of "
                "its regime weights and the equal-weight benchmark.")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--n-sim", type=int, default=1000)
    ap.add_argument("--n-days", type=int, default=252)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)

    if args.synthetic:
        returns, data = synthetic_returns(), "synthetic"
    else:
        from ..data.market import load_portfolio_data

        loaded = load_portfolio_data()
        if loaded["returns"] is None:
            returns, data = synthetic_returns(), "synthetic_fallback"
        else:
            returns = np.asarray(loaded["returns"].values, np.float32)
            data = "market"

    print("training GMM stack...")
    system = train_improved_system(returns, n_regimes=3, num_epochs=100,
                                   patience=20, log_fn=None, device=dev)
    feats = prepare_regime_features(returns)
    regimes = system.detector.predict_regime(feats)
    aligned = returns[-len(regimes):]

    # regime-conditional statistics and Monte Carlo
    means, covs = regime_statistics(aligned, regimes, K=3)
    head = system.optimizer.eval()

    def weight_fn(onehot):
        return head(onehot[None])[0]

    print(f"running {args.n_sim} Monte Carlo paths x {args.n_days} days...")
    mc = monte_carlo_simulation(weight_fn, means, covs,
                                torch.Generator().manual_seed(MC_SEED),
                                n_sim=args.n_sim, n_days=args.n_days,
                                device=dev)
    stats = analyze_monte_carlo(mc)
    print("Monte Carlo:", {k: round(v, 4) for k, v in stats.items()})
    fig = plot_monte_carlo(mc, os.path.join(args.outdir,
                                            "monte_carlo_results.png"))
    if fig is not None:
        print("saved monte_carlo_results.png")

    # the equal-weight benchmark (reference backtest.py:295-305)
    bench = benchmark_equal_weight(aligned)
    print("equal-weight benchmark:",
          {k: round(v, 4) for k, v in bench.items()})
    write_json(args.outdir, "backtest_summary.json", {
        "data": data, "days": int(returns.shape[0]),
        "assets": int(returns.shape[1]), "n_sim": args.n_sim,
        "n_days": args.n_days,
        "seeds": {"gmm": 0, "head": 0, "monte_carlo": MC_SEED},
        "regime_days": np.bincount(regimes, minlength=3).tolist(),
        "monte_carlo": stats, "equal_weight": bench,
        "head_history": [float(h) for h in system.history],
        **device_record(dev)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
