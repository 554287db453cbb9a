"""Two-stage head training: a frozen VAE-HMM posterior feeds a downstream
model (counterpart of vqvaehmm_tpu/train/heads.py).  Covers the
reference's
* train_portfolio            (training.py:126-163): cosine learning rate a
  epoch, global-norm clip 1.0, turnover against the previous batch's
  weights;
* train_portfolio_fused      the same updates with no host fetch until the
  end;
* train_portfolio_optimizer  (VQ_VAE_HMM_fixed.py:230-250): Sharpe loss,
  plain Adam;
* train_delta_hedger         (delta_hedger.py:203-235).

The head is an nn.Module trained in place; `HeadTrainResult.params` is a
copy of its state_dict.  No gradient reaches the VAE: each batch's
posterior is computed once, before the epochs, under torch.no_grad(), so
on a CUDA model it is one launch of the encoder kernel a batch
(ops/fused_encoder.py; the kernel refuses grad mode).  It is not computed
under torch.inference_mode(): an inference tensor cannot be saved for the
head's backward.

The optimizer is the JAX package's: optax's clip_by_global_norm then Adam
(train/trainer.py::ClippedAdam), the update scaled by the epoch's cosine
factor 0.5 (1 + cos(pi ep / E)), which here is the learning rate of the
epoch.  Portfolio heads train in eval() mode: the JAX trainers call the
head without a dropout key, which is its deterministic mode.  Each
trainer restores the module's mode on return.

Batches must be full windows, as in the JAX package: a pointwise head
reads t = T-1, which in a padded batch would be padding.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..losses.portfolio import delta_hedge_loss, portfolio_loss, sharpe_loss
from .trainer import ClippedAdam


class HeadTrainResult(NamedTuple):
    params: Dict[str, torch.Tensor]
    history: list


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _require_full_windows(batches) -> None:
    """Head trainers take complete windows (module docstring): a ragged
    batch would train pointwise heads on padding."""
    for i, (x, _, lengths) in enumerate(batches):
        T = x.shape[-1]
        if lengths is not None and (_host(lengths) < T).any():
            raise ValueError(
                f"batch {i} has lengths < T={T}: head trainers require "
                "full windows (pointwise heads read t = T-1, which would "
                "be padding)")


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def _tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def frozen_posteriors(vae, batches, device=None) -> List[torch.Tensor]:
    """The posterior q (B, K, T) of each batch's x, computed on the VAE's
    device under torch.no_grad() (on the card, one launch of the encoder
    kernel a batch) and moved to `device` (default: the VAE's)."""
    with torch.no_grad():
        return [vae.posterior(_tensor(x, vae.device)).to(device or vae.device)
                for x, _, _ in batches]


def _lr_scale(ep: int, num_epochs: int, use_scheduler: bool) -> float:
    """torch's CosineAnnealingLR(T_max=E) factor for epoch `ep`."""
    if not use_scheduler:
        return 1.0
    return 0.5 * (1 + math.cos(math.pi * ep / num_epochs))


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _clone_state(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


@contextmanager
def _mode(module: torch.nn.Module, training: bool):
    """The module in train (or eval) mode for a block, its mode restored
    after."""
    was = module.training
    module.train(training)
    try:
        yield
    finally:
        module.train(was)


def _portfolio_step(head, opt: ClippedAdam, loss_fn, q, r, prev_w):
    """One update of the head; (loss, weights), both detached.  prev_w
    None is the very first update, which has no turnover term (the
    reference passes prev_weights=None there, training.py:133,148)."""
    opt.zero_grad(set_to_none=True)
    w = head(q)
    loss = loss_fn(w, r, prev_w, q)
    loss.backward()
    opt.update()
    return loss.detach(), w.detach()


def train_portfolio(head_model, vae_model, batches, returns_data,
                    num_epochs: int = 100, lr: float = 0.001,
                    use_scheduler: bool = True,
                    loss_fn: Optional[Callable] = None,
                    gradient_clip: float = 1.0,
                    log_fn=print) -> HeadTrainResult:
    """A portfolio head on frozen posteriors, the previous update's
    weights carried across batches and epochs for the turnover term
    (reference: training.py:126-163).

    batches: a list of (x, u, lengths) batches; returns_data[i] is batch
    i's (B, horizon, n_assets) returns (the reference indexes returns_data
    by batch, training.py:142).  One host fetch an epoch."""
    loss_fn = loss_fn or portfolio_loss
    _require_full_windows(batches)
    dev = _device_of(head_model)
    qs = frozen_posteriors(vae_model, batches, dev)
    rets = [_tensor(r, dev) for r in returns_data]
    opt = ClippedAdam(head_model.parameters(), lr, gradient_clip)
    history = []
    prev_w = None
    with _mode(head_model, False):
        for ep in range(num_epochs):
            _set_lr(opt, lr * _lr_scale(ep, num_epochs, use_scheduler))
            epoch_loss = torch.zeros((), device=dev)
            for q, r in zip(qs, rets):
                loss, prev_w = _portfolio_step(head_model, opt, loss_fn, q,
                                               r, prev_w)
                epoch_loss = epoch_loss + loss
            history.append(float(epoch_loss) / max(len(batches), 1))
            if log_fn:
                log_fn(f"Epoch {ep + 1}/{num_epochs}, "
                       f"Loss: {history[-1]:.4f}")
    return HeadTrainResult(_clone_state(head_model), history)


def train_portfolio_fused(head_model, vae_model, batches, returns_data,
                          num_epochs: int = 100, lr: float = 0.001,
                          use_scheduler: bool = True,
                          loss_fn: Optional[Callable] = None,
                          gradient_clip: float = 1.0) -> HeadTrainResult:
    """train_portfolio with no host fetch until the end: the posteriors are
    stacked once, every epoch's loss (the mean over its batches) stays on
    the device, and the E losses are fetched together.  The updates are
    train_portfolio's, so the per-epoch losses equal its own.  Batches
    must share one shape (they are stacked), and there must be one."""
    loss_fn = loss_fn or portfolio_loss
    if not batches:
        raise ValueError("train_portfolio_fused requires >= 1 batch")
    _require_full_windows(batches)
    dev = _device_of(head_model)
    qs = torch.stack(frozen_posteriors(vae_model, batches, dev))
    rets = torch.stack([_tensor(r, dev) for r in returns_data])
    opt = ClippedAdam(head_model.parameters(), lr, gradient_clip)
    epoch_losses = []
    prev_w = None
    with _mode(head_model, False):
        for ep in range(num_epochs):
            _set_lr(opt, lr * _lr_scale(ep, num_epochs, use_scheduler))
            losses = []
            for i in range(qs.shape[0]):
                loss, prev_w = _portfolio_step(head_model, opt, loss_fn,
                                               qs[i], rets[i], prev_w)
                losses.append(loss)
            epoch_losses.append(torch.stack(losses).mean())
    history = torch.stack(epoch_losses).cpu().double().tolist() \
        if epoch_losses else []
    return HeadTrainResult(_clone_state(head_model), history)


def train_portfolio_optimizer(head_model, vae_model, batches, returns_data,
                              num_epochs: int = 50, lr: float = 1e-3,
                              log_fn=print) -> HeadTrainResult:
    """The simple variant: Sharpe loss, Adam with no clip and no schedule,
    no turnover (reference: VQ_VAE_HMM_fixed.py:230-250)."""
    _require_full_windows(batches)
    dev = _device_of(head_model)
    qs = frozen_posteriors(vae_model, batches, dev)
    rets = [_tensor(r, dev) for r in returns_data]
    opt = ClippedAdam(head_model.parameters(), lr)
    history = []
    with _mode(head_model, False):
        for ep in range(num_epochs):
            epoch_loss = torch.zeros((), device=dev)
            for q, r in zip(qs, rets):
                opt.zero_grad(set_to_none=True)
                loss = sharpe_loss(head_model(q), r)
                loss.backward()
                opt.update()
                epoch_loss = epoch_loss + loss.detach()
            history.append(float(epoch_loss) / max(len(batches), 1))
            if log_fn:
                log_fn(f"Epoch {ep + 1}/{num_epochs}, "
                       f"Loss: {history[-1]:.4f}")
    return HeadTrainResult(_clone_state(head_model), history)


def train_delta_hedger(hedger, vae_model, spot_batches, futures_data,
                       num_epochs: int = 50, lr: float = 0.001,
                       gradient_clip: float = 1.0, is_lstm: bool = False,
                       log_fn=print) -> HeadTrainResult:
    """A hedger on frozen posteriors through delta_hedge_loss (reference:
    delta_hedger.py:203-235).

    spot_batches: (x, u, lengths) batches; futures_data[i]: batch i's
    futures returns (B, T-1, n_assets).  Spot returns are x's first
    differences along time (reference :215).  A pointwise hedger takes
    hedger(q, x[:, :, -1], ones); an LSTM hedger (is_lstm) takes
    hedger(q, x).  The hedgers carry no dropout, and the trainer runs them
    in train() mode, which the card's LSTM backward (cuDNN) requires."""
    _require_full_windows(spot_batches)
    dev = _device_of(hedger)
    qs = frozen_posteriors(vae_model, spot_batches, dev)
    xs = [_tensor(x, dev) for x, _, _ in spot_batches]
    futs = [_tensor(f, dev) for f in futures_data]
    opt = ClippedAdam(hedger.parameters(), lr, gradient_clip)
    history = []
    with _mode(hedger, True):
        for ep in range(num_epochs):
            epoch_loss = torch.zeros((), device=dev)
            for q, x, fut in zip(qs, xs, futs):
                spot_ret = (x[:, :, 1:] - x[:, :, :-1]).transpose(1, 2)
                opt.zero_grad(set_to_none=True)
                if is_lstm:
                    h = hedger(q, x)
                else:
                    h, _ = hedger(q, x[:, :, -1], torch.ones_like(x[:, :, -1]))
                loss = delta_hedge_loss(h, spot_ret, fut)
                loss.backward()
                opt.update()
                epoch_loss = epoch_loss + loss.detach()
            history.append(float(epoch_loss) / max(len(spot_batches), 1))
            if log_fn:
                log_fn(f"Epoch {ep + 1}/{num_epochs}, "
                       f"Loss: {history[-1]:.6f}")
    return HeadTrainResult(_clone_state(hedger), history)
