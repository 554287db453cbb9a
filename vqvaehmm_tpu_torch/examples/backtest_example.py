"""Backtesting example (the JAX package's examples/backtest_example.py on
the port): a basic backtest, walk-forward, strategy comparison, Monte
Carlo.

The posteriors go through kernel 8 (one launch a backtest run: its
windows are encoded in one batch); the Monte Carlo draws come from a
torch.Generator.  The strategy table is a pandas DataFrame where pandas
is installed, and the same rows as a dict where it is not.

    python -m vqvaehmm_tpu_torch.examples.backtest_example [--device cpu]
"""

from importlib.util import find_spec
from typing import Optional

import numpy as np
import torch

from ..backtest import (Backtester, WalkForwardBacktest, analyze_monte_carlo,
                        compare_strategies, monte_carlo_simulation)
from ..core.device import resolve_device
from ..data.synthetic import synthetic_sequences
from ..models.portfolio import HeadConfig, RegimePortfolioOptimizer
from ..models.vae_hmm import make_model
from . import parser


def run(device="cuda", init: Optional[dict] = None,
        head_init: Optional[dict] = None) -> dict:
    """The example on `device`.  init / head_init: state_dicts of the
    VAE-HMM and the head (default: drawn from seeds 0 and 1); the Monte
    Carlo draws come from a generator seeded 2.  Returns the backtest's
    metrics, the walk-forward windows, the strategy table and the Monte
    Carlo summary."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    T, A = 400, 10
    prices = 100 * np.cumprod(1 + rng.normal(3e-4, 0.01, (T, A)), axis=0)
    returns = np.vstack([np.zeros((1, A)),
                         np.diff(prices, axis=0) / prices[:-1]])
    xs, us, _ = synthetic_sequences(1, T, seed=0)

    model = make_model(5, 16, 3, 8, u_dim=4, trans_hidden=16, device=dev,
                       generator=torch.Generator().manual_seed(0)).eval()
    head = RegimePortfolioOptimizer(
        HeadConfig(K=3, n_assets=A), device=dev,
        generator=torch.Generator().manual_seed(1)).eval()
    if init is not None:
        model.load_state_dict(init)
    if head_init is not None:
        head.load_state_dict(head_init)

    with torch.no_grad():
        # basic backtest
        bt = Backtester(initial_capital=100000, tx_cost=0.001, device=dev)
        result = bt.run(head, model.posterior, xs, prices, returns,
                        rebalance_freq=5)

        # walk-forward
        wf = WalkForwardBacktest(train_window=252, test_window=21,
                                 retrain_freq=63, backtester=bt)
        wf_results = wf.run(head, model.posterior, lambda d: None, xs,
                            prices, returns)

        # compare
        table = (compare_strategies({"regime": result})
                 if find_spec("pandas") else {"regime": result.metrics})

        # Monte Carlo
        means = rng.normal(5e-4, 2e-4, size=(3, A))
        covs = np.stack([np.eye(A) * 1e-4] * 3)
        mc = monte_carlo_simulation(
            head, means, covs,
            torch.Generator().manual_seed(2), n_sim=200, n_days=126,
            device=dev)
    return {"metrics": dict(result.metrics),
            "walk_forward_windows": len(wf_results), "table": table,
            "monte_carlo": analyze_monte_carlo(mc)}


def main(argv=None) -> int:
    args = parser("backtest_example", __doc__.splitlines()[0]).parse_args(
        argv)
    out = run(args.device)
    print(f"Sharpe Ratio: {out['metrics']['sharpe_ratio']:.2f}")
    print(f"Max Drawdown: {out['metrics']['max_drawdown']:.2%}")
    print(f"walk-forward windows: {out['walk_forward_windows']}")
    print(out["table"])
    print(out["monte_carlo"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
