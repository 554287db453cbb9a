"""The published workflow's downstream stages on the port
(counterpart of scripts/full_recipe.py's data, head, backtest,
walkforward and montecarlo stages):

  data        fixture panel -> the reference feature recipe -> windows of
              100 every 20 days, the whole panel and ground-truth regimes
  head        ImprovedPortfolioOptimizer trained on the frozen posteriors
              of the quality checkpoint (train/heads.py)
  backtest    Backtester with the head and with equal weights
  walkforward WalkForwardBacktest (252/63/126) retraining the head on each
              window, RegimeBacktest with the argmax and the Viterbi
              decode, and the cost of missing the crash regime
  montecarlo  a Viterbi decode of the panel, per-regime return statistics
              and 1000 paths of 252 days

    python -m vqvaehmm_tpu_torch.recipe [--stage all|data|head|...]
        [--outdir build/torch_recipe]
        [--checkpoint-dir artifacts/checkpoints_quality] [--device cuda]

The model is artifacts/config_quality.json with the checkpoint
`vae_hmm_trained.npz` of --checkpoint-dir.  Every stage runs on --device
(the card by default: the posteriors through the encoder kernel, the
decodes through the evidence and Viterbi kernels; --device cpu runs the
plain versions; --device cuda without a GPU raises).  The outputs carry
the JAX recipe's names: data/*.npy, data/returns.csv, data/prices.csv,
portfolio_head.npz (the JAX package's stacked layout),
head_history.json, backtest_metrics.json, walkforward_metrics.json,
monte_carlo_stats.json, stage_log.json and the PNGs where matplotlib is
present.  The default --outdir is under build/, so the committed
artifacts/ are never overwritten.

The head's initial weights come from a torch.Generator seeded with 7 and
the Monte Carlo draws from one seeded with 0, where the JAX recipe uses
PRNGKey(7) and PRNGKey(0): the streams differ, so the numbers are the
JAX recipe's only up to those draws.  The JAX recipe's train, quality,
eval, vq and report stages are not here: training and evaluation are the
port's own entry points (train/pipeline.py, eval/evaluate.py).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import subprocess
import time
from importlib.util import find_spec

import numpy as np
import torch

from .backtest import montecarlo
from .backtest.backtester import (Backtester, RegimeBacktest,
                                  WalkForwardBacktest, compare_strategies,
                                  plot_results)
from .core.config import load_config
from .core.device import resolve_device
from .data import market
from .data.checkpoint import (head_params_to_numpy, load_improved_head,
                              load_params_npz, params_from_numpy,
                              save_params_npz)
from .models.portfolio import HeadConfig, ImprovedPortfolioOptimizer
from .models.vae_hmm import VAEHMM
from .train.heads import train_portfolio_fused

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "market_fixture.csv")
CONFIG = os.path.join(ROOT, "artifacts", "config_quality.json")
CHECKPOINT_DIR = os.path.join(ROOT, "artifacts", "checkpoints_quality")
OUTDIR = os.path.join(ROOT, "build", "torch_recipe")

SEQ_LEN, STRIDE = 100, 20
HEAD = HeadConfig(K=3, n_assets=10, hidden_dim=64)
HEAD_SEED, HEAD_EPOCHS, HEAD_LR = 7, 100, 1e-3
WF_EPOCHS, WF_WIN, WF_HOR = 20, 64, 20
MC_SEED, MC_PATHS, MC_DAYS = 0, 1000, 252
STAGES = ["data", "head", "backtest", "walkforward", "montecarlo"]


def _inference(fn):
    """fn called under torch.inference_mode(): the kernels of the
    posterior and the decodes carry no gradient."""
    def wrapped(*args):
        with torch.inference_mode():
            return fn(*args)
    return wrapped


def _write_frame(path: str, frame: market.Frame) -> None:
    """A Frame as the CSV pandas' to_csv writes: a `Date` column and the
    values at full precision, NaN as an empty cell."""
    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["Date"] + list(frame.columns))
        for d, row in zip(frame.index, frame.values):
            out.writerow([d] + ["" if np.isnan(v) else repr(float(v))
                                for v in row])


def _read_values(path: str) -> np.ndarray:
    """The values of a _write_frame CSV, (T, columns) float64."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))[1:]
    return np.array([[float(v) if v != "" else np.nan for v in r[1:]]
                     for r in rows], dtype=np.float64)


def _data(outdir: str, name: str):
    path = os.path.join(outdir, "data", name)
    return _read_values(path) if name.endswith(".csv") else np.load(path)


def stage_data(outdir: str, device=None, checkpoint_dir=None) -> None:
    """Fixture -> the reference feature recipe (data/market.py) ->
    windowed sequences, the whole panel, and the ground-truth regime of
    each window step and panel day."""
    prices, regime_data, regimes = market.load_fixture_frames(FIXTURE)
    x_data, u_data, returns, aligned_prices = market.prepare_sequences(
        prices, regime_data)
    x_seq, u_seq = market.create_sequences(x_data, u_data, SEQ_LEN, STRIDE)
    x_seq = np.transpose(x_seq, (0, 2, 1)).astype(np.float32)
    u_seq = np.transpose(u_seq, (0, 2, 1)).astype(np.float32)

    # the ground-truth regime of each kept day, aligned by date
    row = {d: i for i, d in enumerate(prices.index)}
    z_aligned = regimes[[row[d] for d in returns.index]]
    z_win = np.stack([z_aligned[i:i + SEQ_LEN]
                      for i in range(0, len(x_data) - SEQ_LEN, STRIDE)])

    d = os.path.join(outdir, "data")
    os.makedirs(d, exist_ok=True)
    np.save(os.path.join(d, "x_sequences.npy"), x_seq)
    np.save(os.path.join(d, "u_sequences.npy"), u_seq)
    np.save(os.path.join(d, "z_windows.npy"), z_win)
    np.save(os.path.join(d, "x_panel.npy"), x_data.astype(np.float32))
    np.save(os.path.join(d, "u_panel.npy"), u_data.astype(np.float32))
    np.save(os.path.join(d, "z_panel.npy"), z_aligned)
    _write_frame(os.path.join(d, "returns.csv"), returns)
    _write_frame(os.path.join(d, "prices.csv"), aligned_prices)
    print(f"data: x {x_seq.shape} u {u_seq.shape} "
          f"panel T={len(x_data)} assets={returns.values.shape[1]}")


def load_trained(device, checkpoint_dir: str = CHECKPOINT_DIR) -> VAEHMM:
    """The quality configuration's VAE-HMM in eval() mode on `device`,
    from `checkpoint_dir`/vae_hmm_trained.npz."""
    model = VAEHMM(load_config(CONFIG).model, device=device)
    model.load_state_dict(params_from_numpy(load_params_npz(
        os.path.join(checkpoint_dir, "vae_hmm_trained.npz"))))
    return model.eval()


def initial_head(device) -> ImprovedPortfolioOptimizer:
    """The head the head stage starts from, drawn from a Generator seeded
    with HEAD_SEED (on the CPU, so every device starts alike)."""
    return ImprovedPortfolioOptimizer(
        HEAD, device=device,
        generator=torch.Generator().manual_seed(HEAD_SEED))


def head_batches(outdir: str, batch_size: int = 16, horizon: int = 20):
    """Batches of whole windows and the returns of the `horizon` days
    after each window, the aligned counterpart of the reference's
    returns_data[idx] (training.py:133-148).  Uniform batches only: the
    ragged tail is dropped."""
    x, u = _data(outdir, "x_sequences.npy"), _data(outdir, "u_sequences.npy")
    rets = _data(outdir, "returns.csv")
    starts = np.arange(len(x)) * STRIDE
    keep = starts + SEQ_LEN + horizon <= len(rets)
    x, u, starts = x[keep], u[keep], starts[keep]
    horizons = np.stack([rets[s + SEQ_LEN: s + SEQ_LEN + horizon]
                         for s in starts]).astype(np.float32)
    batches, returns_data = [], []
    for i in range(0, len(x) - batch_size + 1, batch_size):
        xb, ub = x[i:i + batch_size], u[i:i + batch_size]
        batches.append((xb, ub, np.full(len(xb), xb.shape[2], np.int32)))
        returns_data.append(horizons[i:i + batch_size])
    return batches, returns_data


def stage_head(outdir: str, device, checkpoint_dir: str = CHECKPOINT_DIR):
    """The Improved head on the frozen posteriors: HEAD_EPOCHS epochs of
    train_portfolio_fused at HEAD_LR.  Writes portfolio_head.npz and
    head_history.json; returns the HeadTrainResult."""
    model = load_trained(device, checkpoint_dir)
    head = initial_head(device)
    batches, returns_data = head_batches(outdir)
    res = train_portfolio_fused(head, model, batches, returns_data,
                                num_epochs=HEAD_EPOCHS, lr=HEAD_LR)
    save_params_npz(os.path.join(outdir, "portfolio_head.npz"),
                    head_params_to_numpy(res.params))
    with open(os.path.join(outdir, "head_history.json"), "w") as f:
        json.dump({"loss": res.history}, f, indent=2)
    print(f"head: {len(res.history)} epochs, "
          f"loss {res.history[0]:.4f} -> {res.history[-1]:.4f}")
    return res


def _panel(outdir: str):
    """(data (1, C, T), u (1, U, T), prices (T, A), returns (T, A))."""
    return (np.transpose(_data(outdir, "x_panel.npy"))[None],
            np.transpose(_data(outdir, "u_panel.npy"))[None],
            _data(outdir, "prices.csv"), _data(outdir, "returns.csv"))


def _backtester(device, **kw) -> Backtester:
    return Backtester(tx_cost=0.001, slippage=0.0005, device=device, **kw)


def stage_backtest(outdir: str, device, checkpoint_dir: str = CHECKPOINT_DIR):
    """Backtester.run (rebalance every 5 days) with the trained head and
    with equal weights (reference backtest.py:295-305).  Writes
    backtest_metrics.json and backtest_results.png."""
    model = load_trained(device, checkpoint_dir)
    head = load_improved_head(os.path.join(outdir, "portfolio_head.npz"),
                              device=device)
    data, _, prices, rets = _panel(outdir)
    posterior_fn = _inference(model.posterior)
    bt = _backtester(device, initial_capital=100000.0)
    result = bt.run(_inference(head), posterior_fn, data, prices, rets,
                    rebalance_freq=5)
    n_assets = prices.shape[1]
    eq_result = bt.run(lambda q: torch.full((q.shape[0], n_assets),
                                            1.0 / n_assets,
                                            device=q.device),
                       posterior_fn, data, prices, rets, rebalance_freq=5)
    fig = plot_results(result, title="Regime portfolio (fixture panel)")
    if fig is not None:
        fig.savefig(os.path.join(outdir, "backtest_results.png"), dpi=120)
    payload = {"regime_portfolio": result.metrics,
               "equal_weight": eq_result.metrics}
    with open(os.path.join(outdir, "backtest_metrics.json"), "w") as f:
        json.dump(payload, f, indent=2, default=float)
    print(result.summary())
    print("equal-weight:", json.dumps(eq_result.metrics, default=float))
    if find_spec("pandas") is not None:       # the card's machine has none
        print(compare_strategies({"regime_portfolio": result,
                                  "equal_weight": eq_result}))
    return payload


def walkforward_train_fn(wf: WalkForwardBacktest, head, model, u_panel,
                         rets, model_fn, posterior_fn):
    """The recipe's retraining for WalkForwardBacktest.run: on each train
    window, 16 evenly spaced windows of WF_WIN days with the WF_HOR days
    of returns after each, WF_EPOCHS epochs of train_portfolio_fused on
    the head in place (each retrain starts from the last).  Windows too
    short for that keep the head as it is."""
    pos = {"start": 0}

    def train_fn(window):
        start = pos["start"]
        pos["start"] += wf.retrain_freq
        print(f"  train_fn @{start}...", flush=True)
        W = window.shape[2]
        if W < WF_WIN + WF_HOR + 8:
            return None
        starts = np.linspace(0, W - WF_WIN - WF_HOR, 16).astype(int)
        xb = np.stack([window[0, :, s:s + WF_WIN] for s in starts])
        ub = np.stack([u_panel[start + s:start + s + WF_WIN].T
                       for s in starts]).astype(np.float32)
        lengths = np.full(len(starts), WF_WIN, np.int32)
        horiz = np.stack([rets[start + s + WF_WIN:start + s + WF_WIN + WF_HOR]
                          for s in starts]).astype(np.float32)
        res = train_portfolio_fused(head, model, [(xb, ub, lengths)],
                                    [horiz], num_epochs=WF_EPOCHS, lr=1e-3)
        print(f"  window @{start}: head loss {res.history[0]:.4f} -> "
              f"{res.history[-1]:.4f}", flush=True)
        return model_fn, posterior_fn

    return train_fn


def walk_forward(model, head, outdir: str, device):
    """WalkForwardBacktest(252, 63, 126).run over the panel with the
    recipe's retraining (walkforward_train_fn): the head is retrained in
    place.  Returns the windows' BacktestResults."""
    data, _, prices, rets = _panel(outdir)
    posterior_fn, model_fn = _inference(model.posterior), _inference(head)
    wf = WalkForwardBacktest(train_window=252, test_window=63,
                             retrain_freq=126,
                             backtester=_backtester(device))
    train_fn = walkforward_train_fn(wf, head, model,
                                    _data(outdir, "u_panel.npy"), rets,
                                    model_fn, posterior_fn)
    print("  starting walk-forward loop...", flush=True)
    return wf.run(model_fn, posterior_fn, train_fn, data, prices, rets)


def _maxdd(r: np.ndarray) -> float:
    """Largest drawdown with the starting unit of equity included, so a
    window that only falls reports its fall from entry."""
    if len(r) == 0:
        return 0.0
    eq = np.concatenate([[1.0], np.cumprod(1.0 + r)])
    return float((1.0 - eq / np.maximum.accumulate(eq)).max())


def _episodes(mask: np.ndarray):
    """The (start, stop) of each run of True in `mask`."""
    out, t = [], 0
    while t < len(mask):
        if mask[t]:
            t2 = t
            while t2 < len(mask) and mask[t2]:
                t2 += 1
            out.append((t, t2))
            t = t2
        else:
            t += 1
    return out


def crash_cost(model, head, data, u_data, rets, z_panel, device) -> dict:
    """What missing the crash regime costs: the same head reweighted daily
    (10bp on turnover) on the model's smoothed posterior and on the
    ground-truth one-hot regimes, over the whole panel, and on the days of
    the ground truth's regime 2."""
    with torch.inference_mode():
        gamma = model.smoothed_posterior(
            torch.as_tensor(data, dtype=torch.float32, device=device),
            torch.as_tensor(u_data, dtype=torch.float32,
                            device=device)).cpu().numpy()[0]     # (K, T)
    Tp = min(gamma.shape[1], len(rets), len(z_panel))
    q_model = gamma.T[:Tp]
    q_oracle = np.eye(3, dtype=np.float32)[z_panel[:Tp].astype(int)]
    tx_cost = 0.001

    def arm_returns(q_daily):
        with torch.inference_mode():
            w = head(torch.as_tensor(q_daily, dtype=torch.float32,
                                     device=device)).cpu().numpy()
        r = (w[:-1] * rets[1:Tp]).sum(axis=1)
        turns = np.abs(np.diff(w, axis=0)).sum(axis=1)
        return r - tx_cost * turns

    r_model, r_oracle = arm_returns(q_model), arm_returns(q_oracle)
    crash = z_panel[1:Tp].astype(int) == 2

    def arm_stats(r):
        rc = r[crash]
        # a drawdown an episode: joined episodes would let a peak in one
        # and a trough in a later one make a fall that never happened
        dd_eps = [_maxdd(r[a:b]) for a, b in _episodes(crash)]
        return {
            "total_return": round(float(np.prod(1 + r) - 1), 4),
            "max_drawdown": round(_maxdd(r), 4),
            "crash_days_total_return":
                round(float(np.prod(1 + rc) - 1), 4),
            "crash_days_mean_daily_return":
                round(float(rc.mean()), 6) if len(rc) else 0.0,
            "max_drawdown_within_crash_episodes":
                round(max(dd_eps), 4) if dd_eps else 0.0,
        }

    return {
        "method": "same head, daily reweight, 10bp cost on turnover; "
                  "model arm = smoothed posterior, oracle arm = "
                  "ground-truth one-hot regimes",
        "n_crash_days": int(crash.sum()),
        "model_decode": arm_stats(r_model),
        "oracle_decode": arm_stats(r_oracle),
        "oracle_minus_model_crash_days_return": round(
            float(np.prod(1 + r_oracle[crash])
                  - np.prod(1 + r_model[crash])), 4),
    }


def stage_walkforward(outdir: str, device,
                      checkpoint_dir: str = CHECKPOINT_DIR):
    """Walk-forward backtest retraining the head a window (reference:
    backtesting.py:113-142), the per-regime breakdown under the argmax and
    the Viterbi decode, and the crash-cost comparison.  Writes
    walkforward_metrics.json."""
    model = load_trained(device, checkpoint_dir)
    head = load_improved_head(os.path.join(outdir, "portfolio_head.npz"),
                              device=device)
    data, u_data, prices, rets = _panel(outdir)
    posterior_fn, model_fn = _inference(model.posterior), _inference(head)
    results = walk_forward(model, head, outdir, device)
    total = float(np.prod([1.0 + r.metrics["total_return"]
                           for r in results]))
    sharpes = [r.metrics["sharpe_ratio"] for r in results]
    wf_out = {
        "n_windows": len(results),
        "chained_total_return": round(total - 1.0, 4),
        "mean_window_sharpe": round(float(np.mean(sharpes)), 4),
        "pct_windows_profitable": round(
            float(np.mean([r.metrics["total_return"] > 0
                           for r in results])), 4),
    }

    rb = RegimeBacktest(backtester=_backtester(device))
    decode_fn = _inference(model.viterbi_decode)
    per_regime = {}
    for mode_name, kwargs in [
            ("argmax", dict(decode="argmax")),
            ("viterbi", dict(decode="viterbi", decode_fn=decode_fn,
                             u=u_data))]:
        res_k = rb.run(model_fn, posterior_fn, data, prices, rets, K=3,
                       **kwargs)
        per_regime[mode_name] = {
            str(k): {"sharpe": round(r.metrics["sharpe_ratio"], 4),
                     "total_return": round(r.metrics["total_return"], 4),
                     "n_periods": int(len(r.returns)) + 1}
            for k, r in res_k.items()}

    cost = crash_cost(model, head, data, u_data, rets,
                      _data(outdir, "z_panel.npy"), device)
    payload = {"walk_forward": wf_out, "per_regime": per_regime,
               "crash_cost": cost}
    with open(os.path.join(outdir, "walkforward_metrics.json"), "w") as f:
        json.dump(payload, f, indent=2)
    print("walk-forward:", json.dumps(wf_out))
    print("per-regime:", json.dumps(per_regime))
    print("crash-cost:", json.dumps(cost))
    return payload


def stage_montecarlo(outdir: str, device,
                     checkpoint_dir: str = CHECKPOINT_DIR):
    """The panel's Viterbi regime path (VAEHMM.viterbi_decode), the
    per-regime return statistics, and MC_PATHS paths of MC_DAYS days with
    the trained head.  Writes monte_carlo_stats.json and
    monte_carlo_results.png; returns (the simulation, its statistics)."""
    model = load_trained(device, checkpoint_dir)
    head = load_improved_head(os.path.join(outdir, "portfolio_head.npz"),
                              device=device)
    data, u_data, _, rets = _panel(outdir)
    with torch.inference_mode():
        regimes = model.viterbi_decode(
            torch.as_tensor(data, dtype=torch.float32, device=device),
            torch.as_tensor(u_data, dtype=torch.float32, device=device)
        ).cpu().numpy()[0]
    means, covs = montecarlo.regime_statistics(rets.astype(np.float32),
                                               regimes, K=3)
    mc = montecarlo.monte_carlo_simulation(
        lambda onehot: head(onehot[None])[0], means, covs,
        torch.Generator().manual_seed(MC_SEED), n_sim=MC_PATHS,
        n_days=MC_DAYS, device=device)
    stats = montecarlo.analyze_monte_carlo(mc)
    montecarlo.plot_monte_carlo(mc, os.path.join(outdir,
                                                 "monte_carlo_results.png"))
    with open(os.path.join(outdir, "monte_carlo_stats.json"), "w") as f:
        json.dump({k: float(v) for k, v in stats.items()}, f, indent=2)
    print("monte carlo:", json.dumps({k: round(float(v), 4)
                                      for k, v in stats.items()}))
    return mc, stats


def _log_stage(outdir: str, stage: str, wall_s: float, device) -> None:
    """Record a stage's wall clock and the device it ran on in
    stage_log.json."""
    try:
        head = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, cwd=ROOT,
                              timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        head = "unknown"
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    path = os.path.join(outdir, "stage_log.json")
    log = {}
    if os.path.exists(path):
        with open(path) as f:
            log = json.load(f)
    log[stage] = {"wall_s": round(wall_s, 1), "backend": device.type,
                  "device": name, "git_head": head}
    with open(path, "w") as f:
        json.dump(log, f, indent=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vqvaehmm_tpu_torch.recipe",
        description="The published workflow's data, head, backtest, "
                    "walk-forward and Monte Carlo stages on the port.")
    ap.add_argument("--stage", default="all", choices=STAGES + ["all"])
    ap.add_argument("--outdir", default=OUTDIR)
    ap.add_argument("--checkpoint-dir", default=CHECKPOINT_DIR,
                    help="directory of the quality vae_hmm_trained.npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    for s in STAGES if args.stage == "all" else [args.stage]:
        print(f"=== stage: {s} ===", flush=True)
        t0 = time.time()
        globals()["stage_" + s](args.outdir, device, args.checkpoint_dir)
        _log_stage(args.outdir, s, time.time() - t0, device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
