"""The reference's two-stage training CLI (counterpart of scripts/train.py,
reference train.py:1-119).

Stage 1: the VAE-HMM (the reference's widths 5/64/3/32, u 4, transition
hidden 128; B=64) through train_model, on the market data or with
--synthetic on 16 synthetic sequences (kernels C and D on the card).
Stage 2: RegimePortfolioOptimizer on the frozen posteriors (the encoder
kernel once a batch) with the Sharpe loss over random 20-day return
windows.  Writes <outdir>/{vae_hmm,portfolio}.npz in the JAX package's
layout, their reference-loadable .pt twins
(data/checkpoint.py::save_state_dict_file), and train_summary.json.

Without --synthetic the data come from data/market.py::
load_portfolio_data, as in the JAX script: a committed panel named by
VQHMM_MARKET_FIXTURE, else (there is no download) its synthetic windows
and synthetic return windows.

    python -m vqvaehmm_tpu_torch.scripts.train [--synthetic]
        [--epochs 50] [--port-epochs 30] [--lr 1e-3] [--device cuda]
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.checkpoint import save_params_npz, save_state_dict_file
from ..data.dataset import RandomChunkDataset
from ..data.synthetic import synthetic_returns, synthetic_sequences
from ..models.portfolio import HeadConfig, RegimePortfolioOptimizer
from ..models.vae_hmm import make_model
from ..train.heads import train_portfolio_optimizer
from ..train.trainer import train_model
from ._common import device_record, parser, write_json

TICKERS = ["SPY", "QQQ", "IWM", "EFA", "EEM", "AGG", "TLT", "GLD", "VNQ",
           "DBC"]  # the reference's 10-ETF universe (train.py:7-18)
HEAD_SEED, HEAD_BATCHES, HEAD_B, HORIZON = 1, 8, 32, 20


def head_batches(xs, us, returns, n_assets, rng):
    """The head stage's batches of whole windows (a pointwise head reads
    t = T-1) and their return windows: from the market returns where
    there are more than 30 days, else synthetic."""
    T = xs.shape[2]
    batches = []
    for _ in range(HEAD_BATCHES):
        idx = rng.integers(0, len(xs), size=HEAD_B)
        batches.append((np.asarray(xs[idx], np.float32),
                        np.asarray(us[idx], np.float32),
                        np.full(HEAD_B, T, np.int32)))
    if returns is not None and len(returns) > 30:
        r = np.asarray(returns.values, np.float32)
        idx = rng.integers(0, len(r) - HORIZON - 1,
                           size=(HEAD_BATCHES, HEAD_B))
        rets = np.stack([[r[i:i + HORIZON] for i in row] for row in idx])
    else:
        rets = synthetic_returns(HEAD_BATCHES, HEAD_B, HORIZON, n_assets,
                                 seed=2)
    return batches, rets


def main(argv=None) -> int:
    ap = parser("train", "The reference's two-stage training: the "
                "VAE-HMM, then the portfolio head.")
    ap.add_argument("--synthetic", action="store_true",
                    help="synthetic sequences in place of market data")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--port-epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.synthetic:
        xs, us, _ = synthetic_sequences(16, 200, 5, 4, 3, seed=0)
        returns = None
    else:
        from ..data.market import load_portfolio_data

        data = load_portfolio_data(TICKERS)
        xs, us = data["x_sequences"], data["u_sequences"]
        returns = data["returns"]
    dataset = RandomChunkDataset(xs, us, min_len=20, max_len=200)

    # stage 1: the VAE-HMM (the reference's hyperparameters, train.py:24-28)
    model = make_model(5, 64, 3, 32, u_dim=4, trans_hidden=128, device=dev)
    _, hist = train_model(model, dataset, num_epochs=args.epochs,
                          lr=args.lr, batch_size=64, device=dev)
    model.eval()
    os.makedirs(args.outdir, exist_ok=True)
    save_params_npz(os.path.join(args.outdir, "vae_hmm.npz"),
                    model.state_dict())

    # stage 2: the portfolio head on frozen posteriors
    n_assets = 10
    head = RegimePortfolioOptimizer(
        HeadConfig(K=3, n_assets=n_assets), device=dev,
        generator=torch.Generator().manual_seed(HEAD_SEED))
    batches, rets = head_batches(xs, us, returns, n_assets,
                                 np.random.default_rng(0))
    result = train_portfolio_optimizer(head, model, batches, rets,
                                       num_epochs=args.port_epochs, lr=1e-3)
    save_params_npz(os.path.join(args.outdir, "portfolio.npz"),
                    result.params)
    # reference-loadable .pt twins (reference save_models, train.py:87-93)
    save_state_dict_file(os.path.join(args.outdir, "vae_hmm.pt"),
                         model.state_dict())
    save_state_dict_file(os.path.join(args.outdir, "portfolio.pt"),
                         result.params)
    print(f"saved {args.outdir}/{{vae_hmm,portfolio}}.{{npz,pt}}")
    print(f"final VAE loss {hist[-1]:.4f}, "
          f"final portfolio loss {result.history[-1]:.4f}")
    write_json(args.outdir, "train_summary.json", {
        "data": "synthetic" if args.synthetic else
                ("market" if returns is not None else "synthetic_fallback"),
        "epochs": args.epochs, "port_epochs": args.port_epochs,
        "lr": args.lr, "seeds": {"vae_hmm": 0, "head": HEAD_SEED,
                                 "head_batches": 0},
        "vae_loss_history": hist, "portfolio_loss_history": result.history,
        "final_vae_loss": hist[-1],
        "final_portfolio_loss": result.history[-1],
        "files": ["vae_hmm.npz", "portfolio.npz", "vae_hmm.pt",
                  "portfolio.pt"],
        **device_record(dev)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
