"""Backtesting engine (counterpart of vqvaehmm_tpu/backtest/backtester.py;
reference: backtesting.py:18-211, src/backtesting.py).

The reference's per-timestep loop re-encodes a 20-step window at every
rebalance.  Here all rebalance windows are stacked and scored in one
batched pass on the backtester's device (`device="cuda"` unless the
caller asks for the CPU): `posterior_fn` is handed one float32 tensor (R,
C, window) there, which on the card VAEHMM.posterior runs through the
fused encoder kernel.  The sequential cash accounting (the only true
recurrence) stays a numpy loop in float64 on the host: it is O(T) scalar
bookkeeping with a trade log, and float32 would erode the running cash
balance.  Metrics are numpy on the host (reference formulas,
backtesting.py:79-106).

`posterior_fn` and `model_fn` are closures over a model and a head; they
take and may return tensors (on any device) or numpy arrays.
RegimeBacktest decodes regimes either as the reference does, argmax of
the mean-field q, or exactly, through `decode_fn` (typically
`lambda x, u: fused_viterbi_states(model, x, u)`, one kernel launch for
the whole panel on the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device


def _numpy(a) -> np.ndarray:
    """A closure's output (tensor on any device, or array-like) on the
    host."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclass
class BacktestResult:
    """Results container (reference: backtesting.py:8-16 + the src variant's
    summary/to_dataframe/trade log, src/backtesting.py:16-37,139-145)."""

    returns: np.ndarray
    positions: np.ndarray
    trades: np.ndarray
    metrics: Dict[str, float]
    equity_curve: np.ndarray
    drawdowns: np.ndarray
    trade_log: Optional[List[Dict]] = None

    def summary(self) -> str:
        lines = [f"{k}: {v:.4f}" for k, v in self.metrics.items()]
        return "\n".join(lines)

    def to_dataframe(self):
        import pandas as pd

        return pd.DataFrame({
            "equity": self.equity_curve,
            "drawdown": self.drawdowns,
            "returns": np.concatenate([[0.0], self.returns]),
        })


class Backtester:
    """Core engine with transaction costs and slippage
    (reference: backtesting.py:18-110).

    accounting="cash" (default): explicit self-financing cash ledger —
    share purchases are debited from cash, so portfolio value only moves
    with market P&L and costs.

    accounting="reference": the reference's exact update
    (backtesting.py:59-62), which computes cash as
    `value[t-1] - (positions[t-1] * prices[t-1]).sum()` and never debits
    the purchase — on the FIRST rebalance (prior positions zero) this
    adds the full position value ON TOP of the uninvested cash, roughly
    doubling the portfolio, and it re-inflates any time the portfolio
    holds significant cash.  Kept (and pinned by
    tests/test_backtest.py::test_backtester_matches_reference_loop) only
    as the compatibility target; every number it produces after the
    first rebalance is upward-biased."""

    def __init__(self, initial_capital: float = 100000.0,
                 tx_cost: float = 0.001, slippage: float = 0.0005,
                 max_leverage: float = 1.0, accounting: str = "cash",
                 device="cuda"):
        if accounting not in ("cash", "reference"):
            raise ValueError(f"unknown accounting mode {accounting!r}")
        # where the stacked windows are handed to posterior_fn; a CUDA
        # device on a machine without a GPU raises
        self.device = resolve_device(device)
        self.initial_capital = initial_capital
        self.tx_cost = tx_cost
        self.slippage = slippage
        self.max_leverage = max_leverage
        self.accounting = accounting

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32
                               ).to(self.device)

    # -- model-driven weight schedule (batched encode) ------------------

    def _weight_schedule(self, model_fn: Callable, posterior_fn: Callable,
                         data: np.ndarray, n_periods: int,
                         rebalance_freq: int, window: int = 20,
                         warmup: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """(rebalance steps ts, weights (R, A)) in one batched pass;
        both empty (shape (0,) / (0,)) when no step qualifies.

        Reference loop (backtesting.py:41-46): at each t with
        t % rebalance_freq == 0 and t > window, weights come from the
        posterior of data[:, :, t-window:t].

        warmup: optional (1, C, W>=window) context PRECEDING data (e.g.
        the tail of a walk-forward train window).  With it, every
        t % rebalance_freq == 0 can trade — the posterior window reaches
        back into the warmup — instead of the first `window` steps
        sitting in cash (the reference's dead zone)."""
        arr = np.asarray(data)
        if warmup is not None:
            wu = np.asarray(warmup)
            if wu.shape[-1] < window:
                raise ValueError(
                    f"warmup must carry >= window={window} steps, got "
                    f"{wu.shape[-1]}")
            arr = np.concatenate([wu, arr], axis=-1)
            off = wu.shape[-1]
            ts = [t for t in range(1, n_periods)
                  if t % rebalance_freq == 0]
        else:
            off = 0
            ts = [t for t in range(1, n_periods)
                  if t % rebalance_freq == 0 and t > window]
        if not ts:
            return np.zeros((0,)), np.zeros((0,))
        windows = np.stack(
            [arr[0, :, off + t - window:off + t] for t in ts])
        q = posterior_fn(self._tensor(windows))     # (R, K, window)
        w = _numpy(model_fn(q))                     # (R, A)
        return np.asarray(ts), w

    def run(self, model_fn: Callable, posterior_fn: Callable,
            data, prices: np.ndarray, returns: np.ndarray,
            rebalance_freq: int = 1, window: int = 20,
            warmup=None) -> BacktestResult:
        """model_fn: q -> weights; posterior_fn: x -> q (both closed over
        params).  data: (1, C, T) features; prices: (T, A).

        returns is accepted for reference-signature parity but unused —
        portfolio returns are derived from the equity curve (the
        reference does the same; backtesting.py:93).
        window/warmup: see _weight_schedule."""
        prices = np.asarray(prices, np.float64)
        n_periods, n_assets = prices.shape

        ts, w_sched = self._weight_schedule(model_fn, posterior_fn, data,
                                            n_periods, rebalance_freq,
                                            window=window, warmup=warmup)
        # dense weight/rebalance arrays for the scan
        rebalance = np.zeros(n_periods, bool)
        weights_t = np.zeros((n_periods, n_assets))
        for i, t in enumerate(np.asarray(ts, int)):
            rebalance[t] = True
            weights_t[t] = w_sched[i]

        # leverage clamp.  reference mode: the reference's net-sum rule
        # (backtesting.py:48) — long-short vectors evade it (their net
        # sum can be tiny at huge gross exposure).  cash mode bounds the
        # GROSS |w| sum so max_leverage actually caps exposure.
        if self.accounting == "reference":
            sums = weights_t.sum(-1)
        else:
            sums = np.abs(weights_t).sum(-1)
        over = sums > self.max_leverage
        weights_t[over] = (weights_t[over] / sums[over, None]
                           * self.max_leverage)

        positions = np.zeros((n_periods, n_assets))
        trades = np.zeros((n_periods, n_assets))
        values = np.zeros(n_periods)
        values[0] = self.initial_capital
        trade_log: List[Dict] = []
        total_costs = 0.0

        cash_ledger = self.initial_capital
        for t in range(1, n_periods):
            if rebalance[t]:
                target = weights_t[t] * values[t - 1] / prices[t]
                trades[t] = target - positions[t - 1]
                positions[t] = target
            else:
                positions[t] = positions[t - 1]
            trade_value = np.abs(trades[t] * prices[t]).sum()
            costs = trade_value * (self.tx_cost + self.slippage)
            total_costs += costs
            position_value = (positions[t] * prices[t]).sum()
            if self.accounting == "cash":
                # self-financing: purchases debit (sales credit) cash
                cash_ledger -= (trades[t] * prices[t]).sum() + costs
                values[t] = position_value + cash_ledger
            else:  # "reference": backtesting.py:59-62 verbatim
                cash = values[t - 1] \
                    - (positions[t - 1] * prices[t - 1]).sum()
                values[t] = position_value + cash - costs
            # trade log when the rebalance moves >1% of portfolio value
            # (src variant semantics, src/backtesting.py:139-145)
            if rebalance[t] and trade_value > 0.01 * values[t - 1]:
                trade_log.append({
                    "t": t,
                    "trade_value": float(trade_value),
                    "cost": float(costs),
                    "weights": weights_t[t].tolist(),
                })

        port_returns = np.diff(values) / values[:-1]
        metrics = self._calculate_metrics(port_returns, values)
        metrics["num_trades"] = len(trade_log)
        metrics["cost_ratio"] = float(total_costs / self.initial_capital)
        drawdowns = self._calculate_drawdowns(values)
        return BacktestResult(port_returns, positions, trades, metrics,
                              values, drawdowns, trade_log)

    def _calculate_metrics(self, returns: np.ndarray,
                           equity: np.ndarray) -> Dict[str, float]:
        """Reference formulas (backtesting.py:79-106)."""
        total_return = (equity[-1] - equity[0]) / equity[0]
        ann_return = (1 + total_return) ** (252 / len(returns)) - 1
        ann_vol = returns.std() * np.sqrt(252)
        sharpe = ann_return / ann_vol if ann_vol > 0 else 0.0

        downside = returns[returns < 0]
        # guard the std itself, not just emptiness: ONE losing step has
        # std 0 and would make sortino inf/nan
        dstd = downside.std() * np.sqrt(252) if len(downside) > 0 else 0.0
        downside_std = dstd if dstd > 0 else 1e-8
        sortino = ann_return / downside_std

        cummax = np.maximum.accumulate(equity)
        drawdowns = (equity - cummax) / cummax
        max_dd = drawdowns.min()
        calmar = ann_return / abs(max_dd) if max_dd != 0 else 0.0
        win_rate = (returns > 0).sum() / len(returns)
        return {
            "total_return": float(total_return),
            "annual_return": float(ann_return),
            "annual_volatility": float(ann_vol),
            "sharpe_ratio": float(sharpe),
            "sortino_ratio": float(sortino),
            "max_drawdown": float(max_dd),
            "calmar_ratio": float(calmar),
            "win_rate": float(win_rate),
            "final_value": float(equity[-1]),
        }

    def _calculate_drawdowns(self, equity: np.ndarray) -> np.ndarray:
        cummax = np.maximum.accumulate(equity)
        return (equity - cummax) / cummax


class WalkForwardBacktest:
    """Rolling retrain and per-window backtest (reference:
    backtesting.py:113-142)."""

    def __init__(self, train_window: int = 252, test_window: int = 21,
                 retrain_freq: int = 21,
                 backtester: Optional[Backtester] = None,
                 warmup: bool = True):
        self.train_window = train_window
        self.test_window = test_window
        self.retrain_freq = retrain_freq
        self.backtester = backtester or Backtester()
        # warmup=True feeds each test window the tail of its TRAIN window
        # as posterior context, so trading starts at t=1.  warmup=False
        # reproduces the reference exactly (backtesting.py:122-139):
        # the backtester needs `window` (20) steps of context before the
        # first trade, so the first 20 steps of EVERY test window sit in
        # cash — and at the default test_window=21 the reference's
        # walk-forward never trades at all.
        self.warmup = warmup

    def run(self, model_fn, posterior_fn, train_fn, data,
            prices: np.ndarray, returns: np.ndarray) -> List[BacktestResult]:
        """train_fn(train_data) -> (model_fn, posterior_fn) retrained on the
        window (caller closes over params/state like the reference's
        train_fn(model, vae_hmm, train_data), backtesting.py:132)."""
        results = []
        n_periods = len(prices)
        data = np.asarray(data)
        # + 1: include the last complete window (the reference's bound
        # drops it — its own `min(train_end + test_window, n_periods)`
        # could never bind)
        for start in range(0, n_periods - self.train_window
                           - self.test_window + 1, self.retrain_freq):
            train_end = start + self.train_window
            test_end = min(train_end + self.test_window, n_periods)
            out = train_fn(data[:, :, start:train_end])
            if out is not None:
                model_fn, posterior_fn = out
            wu = (data[:, :, start:train_end] if self.warmup else None)
            result = self.backtester.run(
                model_fn, posterior_fn, data[:, :, train_end:test_end],
                prices[train_end:test_end], returns[train_end:test_end],
                warmup=wu)
            results.append(result)
        return results


class RegimeBacktest:
    """Per-regime performance analysis (reference: backtesting.py:145-171).

    decode='argmax' reproduces the reference's argmax(q) hard decode
    (:155); decode='viterbi' runs exact MAP decoding through the model's
    input-conditioned HMM (pass ``decode_fn``, typically
    ``lambda x, u: fused_viterbi_states(model, x, u)``, plus the
    conditioning inputs ``u``).  Both run on the backtester's device."""

    def __init__(self, backtester: Optional[Backtester] = None):
        self.backtester = backtester or Backtester()

    def run(self, model_fn, posterior_fn, data, prices: np.ndarray,
            returns: np.ndarray, K: int, min_samples: int = 20,
            regimes: Optional[np.ndarray] = None,
            decode: str = "argmax",
            decode_fn: Optional[Callable] = None,
            u: Optional[np.ndarray] = None
            ) -> Dict[int, BacktestResult]:
        data = np.asarray(data)
        if regimes is None:
            if decode == "viterbi":
                if decode_fn is None or u is None:
                    raise ValueError(
                        "decode='viterbi' needs decode_fn (x, u -> states) "
                        "and the conditioning inputs u")
                bt = self.backtester
                states = decode_fn(bt._tensor(data), bt._tensor(u))
                regimes = _numpy(states).squeeze()
            elif decode == "argmax":
                q = _numpy(posterior_fn(self.backtester._tensor(data)))
                regimes = q.argmax(axis=1).squeeze()
            else:
                raise ValueError(f"unknown decode mode {decode!r}")
        results = {}
        for k in range(K):
            mask = regimes == k
            if mask.sum() < min_samples:
                continue
            results[k] = self.backtester.run(
                model_fn, posterior_fn, data[:, :, mask], prices[mask],
                returns[mask])
        return results


def compare_strategies(results: Dict[str, BacktestResult]):
    """Metrics table across strategies (reference: backtesting.py:174-181)."""
    import pandas as pd

    rows = []
    for name, result in results.items():
        m = dict(result.metrics)
        m["strategy"] = name
        rows.append(m)
    return pd.DataFrame(rows).set_index("strategy")


def plot_results(result: BacktestResult, title: str = "Backtest Results"):
    """3-panel equity/drawdown/returns-hist figure
    (reference: backtesting.py:184-211)."""
    try:
        import sys

        import matplotlib
        if "matplotlib.pyplot" not in sys.modules:
            # only force the headless backend when pyplot isn't already
            # configured: switching an interactive figure window to Agg
            # would silently stop every subsequent figure from rendering
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available for plotting")
        return None
    fig, axes = plt.subplots(3, 1, figsize=(12, 10))
    axes[0].plot(result.equity_curve)
    axes[0].set_title(f"{title} - Equity Curve")
    axes[0].set_ylabel("Portfolio Value")
    axes[0].grid(True)
    axes[1].fill_between(range(len(result.drawdowns)), result.drawdowns, 0,
                         alpha=0.3)
    axes[1].set_title("Drawdown")
    axes[1].set_ylabel("Drawdown %")
    axes[1].grid(True)
    axes[2].hist(result.returns, bins=50, alpha=0.7)
    axes[2].set_title("Returns Distribution")
    axes[2].set_xlabel("Return")
    axes[2].set_ylabel("Frequency")
    axes[2].grid(True)
    fig.tight_layout()
    return fig
