"""Training strategies for the portfolio heads (counterpart of
vqvaehmm_tpu/train/strategies.py): MAML meta-learning, online learning
with an EMA shadow, and walk-forward retraining.

Each strategy holds an nn.Module and calls it as `model(q)`, the JAX
package's keyless call: pass a head with dropout in eval() mode.  Inputs
are moved to the model's device.

* MetaPortfolioOptimizer is second-order, as JAX's jax.grad through
  jax.grad: the inner SGD steps run on `torch.func.functional_call` with
  `torch.autograd.grad(..., create_graph=True)`, and the meta step's
  backward goes through them.  cuDNN's RNN kernels have no double
  backward, so on a CUDA device the meta step of a model holding an RNN
  runs with cuDNN disabled (torch's own CUDA LSTM cell, whose backward is
  differentiable), on the card all the same.
* OnlinePortfolioOptimizer: the global-norm clip is optax's
  (train/trainer.py::ClippedAdam), the EMA shadow decay * e + (1 - decay)
  * p after each update; a custom loss_fn gets its own step, cached.
* WalkForwardTrainer: a fresh Adam a window; `lr` and `loss_fn` are read
  at each window, so changing them between windows takes effect.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

import torch
from torch.func import functional_call

from ..losses.portfolio import sharpe_loss
from .trainer import ClippedAdam


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _tensor(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(dev)


def _second_order_context(model: torch.nn.Module):
    """cuDNN off for a CUDA model holding an RNN: cuDNN's RNN backward is
    not differentiable, torch's own CUDA LSTM cell's is."""
    if _device(model).type == "cuda" and any(
            isinstance(m, torch.nn.RNNBase) for m in model.modules()):
        return torch.backends.cudnn.flags(enabled=False)
    return contextlib.nullcontext()


class MetaPortfolioOptimizer:
    """MAML: n_inner differentiable SGD steps at inner_lr on each task's
    support set, the adapted parameters' loss on its query set summed over
    the tasks, and one Adam step at outer_lr on that sum."""

    def __init__(self, model: torch.nn.Module, inner_lr: float = 0.01,
                 outer_lr: float = 0.001, n_inner: int = 5):
        self.model = model
        self.inner_lr = inner_lr
        self.n_inner = n_inner
        self.meta_opt = ClippedAdam(model.parameters(), outer_lr)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def _adapt(self, params, support, loss_fn, create_graph: bool):
        q, rets = support
        for _ in range(self.n_inner):
            loss = loss_fn(functional_call(self.model, params, (q,)), rets)
            grads = torch.autograd.grad(
                loss, list(params.values()), create_graph=create_graph,
                allow_unused=True, materialize_grads=True)
            params = {k: p - self.inner_lr * g
                      for (k, p), g in zip(params.items(), grads)}
        return params

    def adapt(self, support_data,
              loss_fn: Callable) -> Dict[str, torch.Tensor]:
        """The task-adapted parameters of one support set (q, returns)."""
        dev = _device(self.model)
        support = tuple(_tensor(a, dev) for a in support_data)
        with _second_order_context(self.model):
            adapted = self._adapt(self.params, support, loss_fn, False)
        return {k: v.detach() for k, v in adapted.items()}

    def meta_update(self, tasks, loss_fn: Callable) -> float:
        """One second-order meta step over tasks [((q, rets) support,
        (q, rets) query), ...]; returns the summed query loss before it."""
        dev = _device(self.model)
        total = 0.0
        with _second_order_context(self.model):
            for support, query in tasks:
                support = tuple(_tensor(a, dev) for a in support)
                q, rets = (_tensor(a, dev) for a in query)
                adapted = self._adapt(self.params, support, loss_fn, True)
                total = total + loss_fn(
                    functional_call(self.model, adapted, (q,)), rets)
            params = list(self.model.parameters())
            grads = torch.autograd.grad(total, params, allow_unused=True,
                                        materialize_grads=True)
        for p, g in zip(params, grads):
            p.grad = g
        self.meta_opt.update()
        return float(total.detach())


class OnlinePortfolioOptimizer:
    """One clipped Adam update a call of update(), and an EMA shadow of
    the parameters; use_ema() swaps the shadow in."""

    def __init__(self, model: torch.nn.Module, lr: float = 0.001,
                 ema_decay: float = 0.99, gradient_clip: float = 1.0):
        self.model = model
        self.ema_decay = ema_decay
        self.optimizer = ClippedAdam(model.parameters(), lr, gradient_clip)
        self.ema_params = {k: p.detach().clone()
                           for k, p in model.named_parameters()}
        self._step = self._make_step(sharpe_loss)
        self._custom_steps: Dict[Callable, Callable] = {}

    def _make_step(self, loss_fn: Callable) -> Callable:
        model, d = self.model, self.ema_decay
        named = list(model.named_parameters())

        def step(q: torch.Tensor, rets: torch.Tensor) -> torch.Tensor:
            loss = loss_fn(model(q), rets)
            grads = torch.autograd.grad(loss, [p for _, p in named],
                                        allow_unused=True,
                                        materialize_grads=True)
            for (_, p), g in zip(named, grads):
                p.grad = g
            self.optimizer.update()
            with torch.no_grad():
                for k, p in named:
                    self.ema_params[k] = d * self.ema_params[k] + (1 - d) * p
            return loss.detach()

        return step

    def update(self, regime_probs, returns, loss_fn=None) -> float:
        dev = _device(self.model)
        q, rets = _tensor(regime_probs, dev), _tensor(returns, dev)
        if loss_fn is None:
            step = self._step
        else:
            step = self._custom_steps.get(loss_fn)
            if step is None:
                step = self._custom_steps[loss_fn] = self._make_step(loss_fn)
        return float(step(q, rets))

    def use_ema(self) -> None:
        """Copy the EMA shadow into the live parameters."""
        with torch.no_grad():
            for k, p in self.model.named_parameters():
                p.copy_(self.ema_params[k])


class WalkForwardTrainer:
    """Rolling train/test windows along dim 0 of (q, returns), retraining
    every retrain_freq rows."""

    def __init__(self, model: torch.nn.Module, loss_fn: Callable,
                 train_window: int = 252, test_window: int = 21,
                 retrain_freq: int = 21, lr: float = 0.001):
        self.model = model
        self.loss_fn = loss_fn
        self.train_window = train_window
        self.test_window = test_window
        self.retrain_freq = retrain_freq
        self.lr = lr

    def train_test_split(self, data, start: int):
        train_end = start + self.train_window
        test_end = train_end + self.test_window
        q, rets = data
        return ((q[start:train_end], rets[start:train_end]),
                (q[train_end:test_end], rets[train_end:test_end]))

    def train_epoch(self, train_data, n_epochs: int = 10) -> float:
        """n_epochs full-batch steps of a fresh Adam at self.lr on
        self.loss_fn; returns the loss before the last step (0.0, and the
        parameters untouched, for n_epochs <= 0)."""
        if n_epochs <= 0:
            return 0.0
        dev = _device(self.model)
        q, rets = (_tensor(a, dev) for a in train_data)
        opt = ClippedAdam(self.model.parameters(), self.lr)
        params = list(self.model.parameters())
        for _ in range(n_epochs):
            loss = self.loss_fn(self.model(q), rets)
            grads = torch.autograd.grad(loss, params, allow_unused=True,
                                        materialize_grads=True)
            for p, g in zip(params, grads):
                p.grad = g
            opt.update()
        return float(loss.detach())

    def evaluate(self, test_data) -> float:
        """The Sharpe ratio of the weighted test returns (ddof=1 std,
        floored at 1e-8)."""
        dev = _device(self.model)
        q, rets = (_tensor(a, dev) for a in test_data)
        with torch.no_grad():
            w = self.model(q)
            pr = (w[:, None, :] * rets).sum(-1)
            sharpe = pr.mean() / torch.clamp(torch.std(pr, correction=1),
                                             min=1e-8)
        return float(sharpe)

    def run(self, full_data, n_periods: int) -> List[Dict[str, float]]:
        T = len(full_data[0])
        need = ((n_periods - 1) * self.retrain_freq + self.train_window
                + self.test_window)
        if T < need:
            raise ValueError(
                f"data has {T} rows but n_periods={n_periods} windows "
                f"need {need} (train {self.train_window} + test "
                f"{self.test_window}, retrain every {self.retrain_freq})")
        results = []
        for i in range(0, n_periods * self.retrain_freq, self.retrain_freq):
            train_data, test_data = self.train_test_split(full_data, i)
            results.append({"train_loss": self.train_epoch(train_data),
                            "test_sharpe": self.evaluate(test_data)})
        return results
