"""A plain training step: the window gather, the loss and gradients
(vaehmm.py), optax's clip_by_global_norm and Adam (betas 0.9 and 0.999,
eps 1e-8, a constant learning rate) on a dict of parameters."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from . import vaehmm
from .precision import exact

BETA1, BETA2, EPS = 0.9, 0.999, 1e-8


def windows(pool_x: torch.Tensor, pool_u: torch.Tensor, si, st, ln,
            T: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The batch of windows of the (B,) triples: x (B, C, T), u (B, U, T)
    holding steps [st, st + ln) of pool sequence si, zeros past ln; and
    the lengths."""
    dev = pool_x.device
    si, st, ln = (torch.as_tensor(a, dtype=torch.int64).to(dev)
                  for a in (si, st, ln))
    t = torch.arange(T, device=dev)
    idx = (st[:, None] + t[None, :]).clamp(max=pool_x.shape[2] - 1)
    keep = (t[None, :] < ln[:, None]).float()

    def take(pool):
        rows = torch.gather(pool[si], 2,
                            idx[:, None, :].expand(-1, pool.shape[1], -1))
        return rows * keep[:, None, :]

    return take(pool_x), take(pool_u), ln


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                        ) -> Dict[str, torch.Tensor]:
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    if float(norm) < max_norm:
        return dict(grads)
    return {n: g / norm.float() * max_norm for n, g in grads.items()}


class Adam:
    """Adam on a dict of float32 parameters, as torch.optim.Adam steps."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr = lr
        self.t = 0
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.t += 1
        c1 = 1.0 - BETA1 ** self.t
        c2 = 1.0 - BETA2 ** self.t
        out = {}
        for n, p in params.items():
            g = grads[n]
            self.m[n] = BETA1 * self.m[n] + (1.0 - BETA1) * g
            self.v[n] = BETA2 * self.v[n] + (1.0 - BETA2) * g * g
            denom = (self.v[n].sqrt() / math.sqrt(c2)) + EPS
            out[n] = p - (self.lr / c1) * self.m[n] / denom
        return out


def steps(params: Dict[str, torch.Tensor], pool_x, pool_u, batches,
          T: int, lr: float, clip: float, betas: List[float],
          rnd=exact, fault: str = "", opt: Adam = None):
    """Train from `params` on `batches`, a list of (si, st, ln) triples,
    one step each, with `opt` (a fresh Adam where None): (losses, the first
    step's clipped gradients, the parameters after the last step, the
    optimizer).  fault, planted: "half_batch" computes each step on the
    first half of its rows; "first_batch" trains every step on the first
    of `batches`."""
    opt = opt or Adam(params, lr)
    if fault == "first_batch":
        batches = [batches[0]] * len(batches)
    losses, first = [], None
    for (si, st, ln), beta in zip(batches, betas):
        x, u, lens = windows(pool_x, pool_u, si, st, ln, T)
        if fault == "half_batch":
            h = x.shape[0] // 2
            x, u, lens = x[:h], u[:h], lens[:h]
        loss, grads = vaehmm.loss_and_grads(params, x, u, lens, beta, rnd)
        grads = clip_by_global_norm(grads, clip)
        if first is None:
            first = grads
        losses.append(loss)
        params = opt.step(params, grads)
    return losses, first, params, opt
