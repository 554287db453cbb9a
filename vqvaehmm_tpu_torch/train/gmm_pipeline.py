"""GMM-stack training (counterpart of vqvaehmm_tpu/train/gmm_pipeline.py),
the reference's alternative pipeline (train_simple.py:63-219):
engineered features -> GMM regimes -> a per-regime-expert portfolio head
trained on the negative Sharpe ratio with a diversification penalty and
early stopping.

The head is models/portfolio.py::ImprovedPortfolioOptimizer, trained in
place by full-batch torch.optim.Adam (betas 0.9/0.999, eps 1e-8 outside
the square root, no clip: optax.adam); the early-stopping best is a copy
of its parameters, loaded back at the end.  It trains in float64 and is
returned in float32, the JAX package's dtype: Adam moves every parameter
by about the learning rate whatever the size of its gradient, so where a
gradient is near zero float32 roundings send two devices' runs apart (an
H100's and the CPU's by 6.8e-5 relative in the loss after 100 epochs on
the fixture panel; in float64 by 4e-16).  `ImprovedSystem.optimizer` is
that head, carrying its parameters (the JAX system keeps them apart in
`params`).  The optional temporal chain is fitted by
models/hmm.py::fit_transitions_em over the GMM's own emission densities.

Archives are the JAX package's `.npz` layout (`save_improved_system`), so
either package loads the other's: the head's leaves are `head_{i}` in
`jax.tree_util`'s flatten order of the JAX head (`HEAD_LEAF_ORDER`).
"""

from __future__ import annotations

import json
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.gmm import (SimpleRegimeDetector, _as_params,
                          prepare_regime_features)
from ..models.portfolio import HeadConfig, ImprovedPortfolioOptimizer

# the JAX head is a dict pytree {fc1, fc2, fc3} of {weight, bias}; its
# flatten order sorts dict keys
HEAD_LEAF_ORDER = tuple(f"fc{i}.{leaf}" for i in (1, 2, 3)
                        for leaf in ("bias", "weight"))


class ImprovedSystem(NamedTuple):
    detector: SimpleRegimeDetector
    optimizer: ImprovedPortfolioOptimizer
    history: list
    # optional learned regime dynamics (log_pi (K,), log_A (K, K)) over the
    # detector's own emission densities (train_improved_system
    # temporal=True); regime_marginals() then gives exact HMM marginals
    chain: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def save(self, path: str) -> None:
        save_improved_system(self, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "ImprovedSystem":
        return load_improved_system(path, device)

    def regime_marginals(self, features,
                         mode: str = "smoothed") -> np.ndarray:
        """(Tf, K) per-day regime posterior: the static GMM
        responsibilities without a chain; with one, exact HMM marginals
        over the same emission densities, mode="smoothed" (all the data)
        or "filtered" (day t from days <= t)."""
        if mode not in ("smoothed", "filtered"):
            raise ValueError(f"unknown mode {mode!r}")
        if self.chain is None:
            return self.detector.predict_proba(features)
        from ..ops import hmm as hmm_ops

        log_obs = self.detector.gmm.log_prob_components(
            self.detector._norm(features)).float()[None]
        fn = (hmm_ops.posterior_marginals if mode == "smoothed"
              else hmm_ops.filtered_marginals)
        with torch.no_grad():
            return fn(*self.chain, log_obs)[0].cpu().numpy()


def save_improved_system(system: ImprovedSystem, path: str) -> None:
    """The whole GMM stack (detector, head, history, chain) in one `.npz`
    of the JAX package's layout."""
    gmm = system.detector.gmm
    if gmm.params is None:
        raise ValueError("cannot save an unfitted system")
    state = system.optimizer.state_dict()
    arrays = {f"head_{i}": state[k].detach().cpu().numpy()
              for i, k in enumerate(HEAD_LEAF_ORDER)}
    cfg = system.optimizer.cfg
    meta = {
        "n_regimes": system.detector.n_regimes,
        "gmm": {"n_init": gmm.n_init, "n_iter": gmm.n_iter,
                "reg_covar": gmm.reg_covar, "seed": gmm.seed,
                "log_likelihood": gmm.log_likelihood_},
        "head": {"K": cfg.K, "n_assets": cfg.n_assets,
                 "hidden_dim": cfg.hidden_dim},
    }
    det = system.detector
    extra = {}
    if det.feature_mu is not None:
        # the normalisation statistics are part of the model
        extra["feature_mu"] = np.asarray(det.feature_mu)
        extra["feature_sd"] = np.asarray(det.feature_sd)
    if system.chain is not None:
        extra["chain_log_pi"] = system.chain[0].cpu().numpy()
        extra["chain_log_A"] = system.chain[1].cpu().numpy()
    w, m, c = (a.cpu().numpy() for a in gmm.params)
    np.savez(path,
             meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
             gmm_weights=w, gmm_means=m, gmm_covs=c,
             history=np.asarray(system.history, np.float64),
             **extra, **arrays)


def load_improved_system(path: str, device="cuda") -> ImprovedSystem:
    """Inverse of save_improved_system (either package's archive), on
    `device`."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        gmm_params = _as_params((z["gmm_weights"], z["gmm_means"],
                                 z["gmm_covs"]), dev)
        history = z["history"].tolist()
        leaves = [z[f"head_{i}"] for i in range(
            sum(1 for k in z.files if k.startswith("head_")))]
        feature_mu = z["feature_mu"] if "feature_mu" in z.files else None
        feature_sd = z["feature_sd"] if "feature_sd" in z.files else None
        chain = (tuple(torch.from_numpy(z[k]).to(dev)
                       for k in ("chain_log_pi", "chain_log_A"))
                 if "chain_log_pi" in z.files else None)

    g = meta["gmm"]
    detector = SimpleRegimeDetector(n_regimes=meta["n_regimes"],
                                    n_init=g["n_init"], seed=g["seed"],
                                    device=dev)
    detector.gmm.n_iter = g["n_iter"]
    detector.gmm.reg_covar = g["reg_covar"]
    detector.gmm.params = gmm_params
    detector.gmm.log_likelihood_ = g["log_likelihood"]
    detector.feature_mu = feature_mu
    detector.feature_sd = feature_sd
    detector.fitted = True

    h = meta["head"]
    head = ImprovedPortfolioOptimizer(HeadConfig(
        K=h["K"], n_assets=h["n_assets"], hidden_dim=h["hidden_dim"]),
        device=dev)
    if len(leaves) != len(HEAD_LEAF_ORDER):
        raise ValueError(
            f"archive {path!r} holds {len(leaves)} head arrays but the "
            f"ImprovedPortfolioOptimizer has {len(HEAD_LEAF_ORDER)} (the "
            "head gained the reference's middle fc2 layer, "
            "train_simple.py:43-44); re-train or re-save the system")
    head.load_state_dict({k: torch.from_numpy(np.asarray(a, np.float32))
                          for k, a in zip(HEAD_LEAF_ORDER, leaves)})
    return ImprovedSystem(detector, head.eval(), history, chain)


def train_improved_system(returns: np.ndarray, n_regimes: int = 3,
                          hidden_dim: int = 64, num_epochs: int = 200,
                          lr: float = 1e-3, lookback: int = 20,
                          diversification_weight: float = 0.1,
                          patience: int = 20, seed: int = 0,
                          temporal: bool = False, dropout: bool = False,
                          log_fn=print, device="cuda",
                          detector: Optional[SimpleRegimeDetector] = None,
                          head_init: Optional[Dict[str, torch.Tensor]] = None
                          ) -> ImprovedSystem:
    """The GMM stack end to end on `device` (reference:
    train_simple.py:103-182).  returns: (T, A) daily asset returns.  Fits
    the GMM on the engineered features, then trains the per-regime head
    full-batch on -Sharpe + diversification_weight * (squared distance
    from equal weight), stopping after `patience` epochs without a gain
    of 1e-5; the best epoch's parameters are returned.

    dropout=True trains with the head's Dropout(0.2) active, its masks
    from a CPU Generator seeded with seed + 1 (the same masks on every
    device); the default is deterministic full-batch training.
    temporal=True also fits regime dynamics over the GMM's emission
    densities (fit_transitions_em, 40 iterations).

    detector: a fitted SimpleRegimeDetector used in place of fitting one;
    head_init: the head's initial state_dict in place of the draw from a
    Generator seeded with `seed` (JAX draws with PRNGKey(seed))."""
    dev = resolve_device(device)
    returns = np.asarray(returns, np.float32)
    T, A = returns.shape

    feats = prepare_regime_features(returns, lookback=lookback)
    if detector is None:
        detector = SimpleRegimeDetector(n_regimes=n_regimes, seed=seed,
                                        device=dev)
        detector.fit(feats)
    probs = detector.predict_proba(feats)              # (Tf, K)
    aligned_returns = returns[-len(probs):]            # align tails

    head = ImprovedPortfolioOptimizer(
        HeadConfig(K=n_regimes, n_assets=A, hidden_dim=hidden_dim),
        device=dev, generator=torch.Generator().manual_seed(seed))
    if head_init is not None:
        head.load_state_dict(head_init)
    head.double().train(dropout)
    opt = torch.optim.Adam(head.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)

    # every step t predicts weights from q_t and is scored on the next
    # `horizon` days of returns
    horizon = 20
    n = len(probs) - horizon
    q_all = torch.from_numpy(probs[:n]).to(dev, torch.float64)  # (N, K)
    fwd_rets = torch.from_numpy(np.stack(
        [aligned_returns[t + 1:t + 1 + horizon] for t in range(n)])
    ).to(dev, torch.float64)                                     # (N, H, A)
    drop_gen = torch.Generator().manual_seed(seed + 1) if dropout else None

    history = []
    best, wait = np.inf, 0
    best_state = {k: v.detach().clone()
                  for k, v in head.state_dict().items()}
    for ep in range(num_epochs):
        w = head(q_all, generator=drop_gen)                      # (N, A)
        pr = (w[:, None, :] * fwd_rets).sum(-1)                  # (N, H)
        sd = torch.clamp_min(pr.std(dim=1, correction=1), 1e-8)
        sharpe = (pr.mean(dim=1) / sd).mean()
        # diversification penalty (reference :146-149)
        div = ((w - 1.0 / A) ** 2).sum(-1).mean()
        loss = -sharpe + diversification_weight * div
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        loss = loss.item()
        history.append(loss)
        if loss < best - 1e-5:
            best, wait = loss, 0
            best_state = {k: v.detach().clone()
                          for k, v in head.state_dict().items()}
        else:
            wait += 1
        if wait >= patience:
            if log_fn:
                log_fn(f"early stop at epoch {ep + 1} (best {best:.4f})")
            break
        if log_fn and (ep + 1) % 50 == 0:
            log_fn(f"Epoch {ep + 1}/{num_epochs}, Loss: {loss:.4f}")
    head.load_state_dict(best_state)
    head.float().eval()
    chain = None
    if temporal:
        from ..models.hmm import fit_transitions_em

        with torch.no_grad():
            log_obs = detector.gmm.log_prob_components(
                detector._norm(feats)).float()[None]
            log_pi, log_A, _ = fit_transitions_em(log_obs, n_iters=40)
        chain = (log_pi, log_A)
    return ImprovedSystem(detector, head, history, chain)


def benchmark_equal_weight(returns: np.ndarray,
                           initial_capital: float = 100000.0,
                           tx_cost: float = 0.001,
                           rebalance_freq: int = 21) -> Dict[str, float]:
    """Equal-weight benchmark with periodic rebalancing costs (reference:
    backtest.py:295-305), float64 numpy on the host as in the JAX
    package."""
    returns = np.asarray(returns, np.float64)
    T, A = returns.shape
    w = np.full(A, 1.0 / A)
    value = initial_capital
    values = [value]
    hold = w.copy()
    for t in range(T):
        day_ret = float((hold * returns[t]).sum())
        value *= 1.0 + day_ret
        # drift
        hold = hold * (1.0 + returns[t])
        s = hold.sum()
        hold = hold / s if s > 0 else np.full(A, 1.0 / A)
        if (t + 1) % rebalance_freq == 0:
            cost = tx_cost * np.abs(hold - w).sum()
            value *= 1.0 - cost
            hold = w.copy()
        values.append(value)
    values = np.asarray(values)
    rets = np.diff(values) / values[:-1]
    ann = (values[-1] / values[0]) ** (252 / max(T, 1)) - 1
    vol = rets.std() * np.sqrt(252)
    cummax = np.maximum.accumulate(values)
    mdd = ((values - cummax) / cummax).min()
    return {
        "total_return": float(values[-1] / values[0] - 1),
        "annual_return": float(ann),
        "annual_volatility": float(vol),
        "sharpe_ratio": float(ann / vol) if vol > 0 else 0.0,
        "max_drawdown": float(mdd),
        "final_value": float(values[-1]),
    }
