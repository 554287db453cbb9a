"""Market feature recipe in numpy (counterpart of
vqvaehmm_tpu/data/market.py:47-106, which runs it in pandas).

x = [mean return, volume proxy, rolling volatility, momentum, mean
log-return] over the asset panel, u = [VIX, 10y yield, SPY 20-day return,
SPY 20-day volatility]; rows with any missing feature are dropped, so
the panels start where the 20-day windows are full.  `Frame` stands in
for the pandas DataFrame: a date index, column names and a float64
matrix.

`load_portfolio_data` is the user's entry point, as in the JAX package:
a committed close-price panel (`fixture_path` or VQHMM_MARKET_FIXTURE,
e.g. tests/fixtures/market_fixture.csv) through the recipe to (N, feat, T)
windows, or the synthetic fallback.  Not ported: `download_data` (it
needs the network), so without a fixture there is no live branch.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_TICKERS = ["AAPL", "MSFT", "JPM", "XOM", "JNJ", "WMT", "PG", "V",
                   "UNH", "HD"]
REGIME_TICKERS = ["^VIX", "^TNX", "SPY"]


@dataclass
class Frame:
    """A date-indexed table: index (T,) of date strings, T rows of
    `columns` float64 values."""

    index: np.ndarray
    columns: List[str]
    values: np.ndarray

    def __getitem__(self, column: str) -> np.ndarray:
        return self.values[:, self.columns.index(column)]

    def rows(self, keep: np.ndarray) -> "Frame":
        return Frame(self.index[keep], list(self.columns), self.values[keep])

    def __len__(self) -> int:
        return len(self.index)

    def between(self, start: str, end: str) -> "Frame":
        """The rows dated from `start` to `end`, both included, as pandas'
        .loc[start:end] takes them from a date index (a partial date such
        as "2023" covers its whole span)."""
        return self.rows(np.array([start <= d and d[:len(end)] <= end
                                   for d in self.index], dtype=bool))


def load_fixture_frames(fixture_path: str
                        ) -> Tuple[Frame, Frame, Optional[np.ndarray]]:
    """A committed close-price panel (a CSV with a `Date` column) as the
    (prices, regime_data) frames the feature recipe takes.  A `__regime__`
    ground-truth column, if present, is split off and returned third as
    ints (else None).  Rows are taken in the file's order, which is date
    order; empty cells read as NaN."""
    with open(fixture_path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [r for r in reader if r]
    if "Date" not in header:
        raise ValueError(f"{fixture_path}: no 'Date' column in {header}")
    d = header.index("Date")
    index = np.array([r[d] for r in rows])
    cols = [c for c in header if c != "Date"]
    table = np.array([[float(r[i]) if r[i] != "" else np.nan
                       for i, c in enumerate(header) if c != "Date"]
                      for r in rows], dtype=np.float64).reshape(len(rows),
                                                                len(cols))
    regimes = None
    if "__regime__" in cols:
        regimes = table[:, cols.index("__regime__")].astype(int)
    regime_cols = [c for c in REGIME_TICKERS if c in cols]
    price_cols = [c for c in cols
                  if c not in regime_cols and c != "__regime__"]

    def take(names):
        return Frame(index, names,
                     table[:, [cols.index(c) for c in names]])

    return take(price_cols), take(regime_cols), regimes


def _pct_change(a: np.ndarray, periods: int = 1) -> np.ndarray:
    """a[t] / a[t - periods] - 1 along axis 0, NaN for the first rows."""
    out = np.full(a.shape, np.nan)
    out[periods:] = a[periods:] / a[:-periods] - 1.0
    return out


def _rolling(a: np.ndarray, window: int, stat: str) -> np.ndarray:
    """Rolling mean or sample standard deviation (ddof 1) over `window`
    rows along axis 0; NaN until the window is full, and wherever it
    holds a NaN."""
    out = np.full(a.shape, np.nan)
    if len(a) >= window:
        win = np.lib.stride_tricks.sliding_window_view(a, window, axis=0)
        out[window - 1:] = win.mean(axis=-1) if stat == "mean" \
            else win.std(axis=-1, ddof=1)
    return out


def _row_mean(a: np.ndarray) -> np.ndarray:
    """Mean over the columns skipping NaN; NaN for a row of NaN only."""
    n = (~np.isnan(a)).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(n > 0, np.nansum(a, axis=1) / n, np.nan)


def prepare_sequences(prices: Frame, regime_data: Frame, lookback: int = 20
                      ) -> Tuple[np.ndarray, np.ndarray, Frame, Frame]:
    """(x_data (N, 5), u_data (N, 4), returns, prices), the two frames
    aligned to the N rows where every feature is present.  prices and
    regime_data share one date index."""
    if not np.array_equal(prices.index, regime_data.index):
        raise ValueError("prices and regime_data must share one date index")
    p = prices.values
    # returns drop every row with a missing value, the first included;
    # the rolling windows then run over the rows that are left
    ret_all = _pct_change(p)
    kept = ~np.isnan(ret_all).any(axis=1)
    ret = ret_all[kept]

    def spread(rows_kept: np.ndarray) -> np.ndarray:
        full = np.full((len(p),) + rows_kept.shape[1:], np.nan)
        full[kept] = rows_kept
        return full

    x_cols = np.stack([
        spread(_row_mean(ret)),
        spread(_row_mean(_rolling(np.abs(ret), lookback, "mean"))),
        spread(_row_mean(_rolling(ret, lookback, "std"))),
        _row_mean(_pct_change(p, lookback)),
        spread(_row_mean(np.log1p(ret))),
    ], axis=1)
    spy = regime_data["SPY"]
    u_cols = np.stack([
        regime_data["^VIX"], regime_data["^TNX"],
        _pct_change(spy, lookback),
        _rolling(_pct_change(spy), lookback, "std"),
    ], axis=1)
    ok = ~(np.isnan(x_cols).any(axis=1) | np.isnan(u_cols).any(axis=1))
    returns = Frame(prices.index, list(prices.columns), ret_all)
    return x_cols[ok], u_cols[ok], returns.rows(ok), prices.rows(ok)


def create_sequences(x_data: np.ndarray, u_data: np.ndarray,
                     seq_len: int = 100, stride: int = 20
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Overlapping windows (N, seq_len, feat) every `stride` rows."""
    xs, us = [], []
    for i in range(0, len(x_data) - seq_len, stride):
        xs.append(x_data[i:i + seq_len])
        us.append(u_data[i:i + seq_len])
    return np.array(xs), np.array(us)


def load_portfolio_data(tickers: Optional[List[str]] = None,
                        start_date: str = "2015-01-01",
                        end_date: str = "2024-01-01",
                        fallback_synthetic: bool = True,
                        fixture_path: Optional[str] = None,
                        log_fn=print) -> Dict:
    """The market pipeline (vqvaehmm_tpu/data/market.py::
    load_portfolio_data): the dict of (N, feat, T) float32 windows
    ("x_sequences", "u_sequences"), the aligned "returns" and "prices"
    Frames and the "tickers".

    With `fixture_path` (or VQHMM_MARKET_FIXTURE) the panel is a committed
    CSV, cut to [start_date, end_date]; a fixture that fails to load
    raises.  Without one there is nothing to download here: the 32
    synthetic windows of 100 steps of JAX's fallback, with returns and
    prices None, or a RuntimeError under fallback_synthetic=False."""
    tickers = tickers or DEFAULT_TICKERS
    fixture_path = fixture_path or os.environ.get("VQHMM_MARKET_FIXTURE")
    if fixture_path:
        if log_fn:
            log_fn(f"Loading fixture {fixture_path}...")
        prices, regime_data, _ = load_fixture_frames(fixture_path)
        prices = prices.between(start_date, end_date)
        regime_data = regime_data.between(start_date, end_date)
        x_data, u_data, returns, aligned = prepare_sequences(prices,
                                                             regime_data)
        x_seq, u_seq = create_sequences(x_data, u_data)
        return {"x_sequences": np.transpose(x_seq, (0, 2, 1))
                .astype(np.float32),
                "u_sequences": np.transpose(u_seq, (0, 2, 1))
                .astype(np.float32),
                "returns": returns, "prices": aligned,
                "tickers": list(prices.columns)}
    if not fallback_synthetic:
        raise RuntimeError(
            "no market data: pass fixture_path or set VQHMM_MARKET_FIXTURE "
            "(this package has no download), or allow fallback_synthetic")
    if log_fn:
        log_fn("market data unavailable (no fixture); using synthetic data")
    from .synthetic import synthetic_sequences

    xs, us, _ = synthetic_sequences(n_sequences=32, seq_len=100,
                                    input_dim=5, u_dim=4, seed=0)
    return {"x_sequences": xs, "u_sequences": us, "returns": None,
            "prices": None, "tickers": tickers}


def create_dataloader(x_sequences, u_sequences, batch_size: int = 32,
                      min_len: int = 20, max_len: int = 100):
    """RandomChunkDataset and its fixed-shape batch iterator for one epoch
    (vqvaehmm_tpu/data/market.py::create_dataloader)."""
    from .dataset import RandomChunkDataset, batch_iterator

    dataset = RandomChunkDataset(x_sequences, u_sequences, min_len=min_len,
                                 max_len=max_len)
    return batch_iterator(dataset, batch_size)
