"""CLI inference report for the port (counterpart of
vqvaehmm_tpu/serve/cli.py): the current regime, the allocation, the
regime distribution over the window and the last N allocations.

    python -m vqvaehmm_tpu_torch.serve.cli --config cfg.json \
        --checkpoint vae_hmm_trained.npz [--head-checkpoint head.pt] \
        [--data x.npy] [--stack vae|gmm|vq] [--device cuda]

--stack vae (default) runs the VAE-HMM (a `.npz` or reference `.pt`
checkpoint) and a portfolio head (`.npz`, or a reference `.pt` of either
family); its posterior is `VAEHMM.posterior`, kernel 8 on a CUDA device.
--stack vq reads a VQStack archive (train/vq_pipeline.py) and reports
from its exact regime marginals.  --stack gmm reads an ImprovedSystem
archive (train/gmm_pipeline.py, the reference CLI's own workflow) and
reports from a (T, A) returns panel (--data, or 252 synthetic days from
np.random.default_rng(0)); it needs no --config.
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch


def report(posterior_fn, weight_fn, x: np.ndarray,
           tickers: Optional[list] = None, last_n: int = 5,
           log_fn=print) -> dict:
    """x: (1, C, T) features.  posterior_fn maps x to the (1, K, T)
    regime posterior and weight_fn a (1, K, t) posterior to (1, A)
    weights, both as numpy arrays."""
    q = np.asarray(posterior_fn(x))                    # (1, K, T)
    T = q.shape[2]
    weights = np.asarray(weight_fn(q))[0]              # (A,)
    # the allocations the last N steps would have made
    last_allocs = [np.asarray(weight_fn(q[:, :, :t + 1]))[0]
                   for t in range(max(0, T - last_n), T)]
    return _summary(q[0].T, weights, last_allocs, tickers, log_fn)


def report_gmm(system, returns: np.ndarray,
               tickers: Optional[list] = None, last_n: int = 5,
               log_fn=print) -> dict:
    """The GMM-stack report from a (T, A) daily-returns panel (the
    reference CLI's workflow, inference.py:19-82): engineered features ->
    the regime posterior (static responsibilities, or the chain's
    smoothed marginals where the system has one) -> the head's
    allocation, on the system's device."""
    from ..models.gmm import prepare_regime_features

    feats = prepare_regime_features(np.asarray(returns, np.float32))
    probs = system.regime_marginals(feats)              # (Tf, K)
    weight_fn = _numpy_fn(system.optimizer, system.detector.gmm.device)
    Tf = probs.shape[0]
    weights = weight_fn(probs[-1:])[0]
    last_allocs = [weight_fn(probs[t:t + 1])[0]
                   for t in range(max(0, Tf - last_n), Tf)]
    return _summary(probs, weights, last_allocs, tickers, log_fn)


def _summary(probs: np.ndarray, weights: np.ndarray, last_allocs,
             tickers: Optional[list], log_fn) -> dict:
    """The report of a (T, K) regime posterior, the current (A,) weights
    and the last allocations, logged through log_fn."""
    T, K = probs.shape
    regimes = probs.argmax(axis=1)
    current_regime = int(regimes[-1])
    tickers = tickers or [f"ASSET{i}" for i in range(len(weights))]
    dist = np.bincount(regimes, minlength=K) / T
    out = {"current_regime": current_regime,
           "regime_probs": probs[-1].tolist(),
           "allocation": dict(zip(tickers, weights.tolist())),
           "regime_distribution": dist.tolist(),
           "last_allocations": [a.tolist() for a in last_allocs]}
    if log_fn:
        log_fn(f"Current regime: {current_regime} "
               f"(p={probs[-1, current_regime]:.3f})")
        log_fn("Allocation:")
        for t_, w_ in zip(tickers, weights):
            log_fn(f"  {t_:8s} {w_ * 100:6.2f}%")
        log_fn("Regime distribution over window: "
               + ", ".join(f"R{k}: {d * 100:.1f}%"
                           for k, d in enumerate(dist)))
    return out


def _numpy_fn(fn, device):
    """fn over tensors on `device`, as a function of numpy arrays, run
    under inference mode (the kernels carry no gradient)."""
    def call(a):
        with torch.inference_mode():
            return fn(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      ).cpu().numpy()
    return call


def _features(path: Optional[str], C: int, U: int, K: int) -> np.ndarray:
    """(1, C, T) float32 from a .npy of (1, C, T) or (C, T), or 100 steps
    of synthetic regime data."""
    if path:
        x = np.load(path)
        return (x[None] if x.ndim == 2 else x).astype(np.float32)
    from ..data.synthetic import synthetic_sequences

    return synthetic_sequences(1, 100, C, U, K)[0]


def _regime_head(cfg, K: int, path: Optional[str], device):
    """A RegimePortfolioOptimizer with its `.npz` loaded, or seeded
    random-init without one."""
    from ..data.checkpoint import (load_params_npz, params_from_numpy,
                                   validate_params_for)
    from ..models.portfolio import HeadConfig, RegimePortfolioOptimizer

    head = RegimePortfolioOptimizer(
        HeadConfig(K=K, n_assets=cfg.portfolio.n_assets,
                   hidden_dim=cfg.portfolio.hidden_dim),
        device=device, generator=torch.Generator().manual_seed(0))
    if path:
        state = params_from_numpy(load_params_npz(path))
        validate_params_for(head, state, what=f"head checkpoint {path!r}")
        head.load_state_dict(state)
    return head.eval()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="configs/config.yaml")
    parser.add_argument("--checkpoint", required=True)
    parser.add_argument("--head-checkpoint", default=None)
    parser.add_argument("--stack", choices=("vae", "gmm", "vq"),
                        default="vae",
                        help="vae: VAE-HMM + portfolio head; gmm: an "
                             "ImprovedSystem archive (checkpoint = its "
                             ".npz); vq: a VQStack archive (checkpoint = "
                             "its vq_stack.npz)")
    parser.add_argument("--data", default=None,
                        help="vae/vq: .npy (1,C,T) features; gmm: .npy "
                             "(T,A) returns; synthetic if unset")
    parser.add_argument("--device", default="cuda",
                        help="torch device; the CPU only when asked for")
    args = parser.parse_args(argv)

    from ..core.config import load_config
    from ..core.device import resolve_device

    device = resolve_device(args.device)
    if args.stack == "gmm":
        from ..train.gmm_pipeline import load_improved_system

        system = load_improved_system(args.checkpoint, device=device)
        if args.data:
            returns = np.load(args.data)
        else:
            rng = np.random.default_rng(0)
            returns = rng.normal(5e-4, 0.01,
                                 size=(252, system.optimizer.cfg.n_assets))
        return report_gmm(system, returns)
    cfg = load_config(args.config)

    if args.stack == "vq":
        from ..train.vq_pipeline import VQStack

        stack = VQStack.load(args.checkpoint, device=device)
        x = _features(args.data, stack.model.cfg.input_dim,
                      cfg.model.u_dim or 1, stack.hmm.K)
        head = _regime_head(cfg, stack.hmm.K, args.head_checkpoint, device)
        codes = _numpy_fn(stack.codes, device)(x)[0]
        print(f"Codes (last 10): {codes[-10:].tolist()}  "
              f"({len(np.unique(codes))}/{stack.model.cfg.num_codes} "
              "codebook entries used)")
        return report(_numpy_fn(lambda a: stack.regime_marginals(
                          a, torch.full((a.shape[0],), a.shape[2],
                                        dtype=torch.int32, device=device)
                      ).transpose(1, 2), device),
                      _numpy_fn(head, device), x)

    from ..data.checkpoint import (load_head_file, load_params_npz,
                                   load_state_dict_file, params_from_numpy,
                                   validate_params_for)
    from ..models.vae_hmm import VAEHMM

    model = VAEHMM(cfg.model, device=device)
    if args.checkpoint.endswith(".npz"):
        state = params_from_numpy(load_params_npz(args.checkpoint))
    else:
        state = load_state_dict_file(args.checkpoint)
    validate_params_for(model, state,
                        what=f"checkpoint {args.checkpoint!r}")
    model.load_state_dict(state)
    model.eval()
    hc = args.head_checkpoint
    if hc and not hc.endswith(".npz"):
        # a reference .pt head: family from its naming, widths from its
        # weights, K held to the model's
        head = load_head_file(hc, K=cfg.model.K, device=device)
    else:
        head = _regime_head(cfg, cfg.model.K, hc, device)
    x = _features(args.data, cfg.model.input_dim, cfg.model.u_dim or 1,
                  cfg.model.K)
    return report(_numpy_fn(model.posterior, device),
                  _numpy_fn(head, device), x)


if __name__ == "__main__":
    main()
