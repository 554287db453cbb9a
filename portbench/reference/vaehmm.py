"""The VAE-HMM of the published reference (yashnaray/VQ-VAE-HMM-model,
`VQ_VAE_HMM_fixed.py`), written out plainly.

* encoder: Conv1d(C, H1, 3, same) + ReLU, Conv1d(H1, H2, 3, same) + ReLU,
  Conv1d(H2, K, 1): x (B, C, T) -> regime logits (B, K, T);
* prior: learnable initial logits, and an MLP u_t -> K x K transition
  logits, Linear(U, HP) + ReLU + Linear(HP, K*K), row log-softmax:
  log_A (B, T, K, K), log_A[b, t, i, j] the step t-1 -> t from i to j;
* decoder: e = q^T E with E (K, D), D = H1, then Conv1d(D, D, 3) + ReLU
  twice and Conv1d(D, 2C, 1) -> (mu, logvar);
* the masked negative ELBO with the reference's normalisations:
  recon / max(mask.sum() * C, 1) + beta * (prior - entropy), the prior
  and entropy terms averaged over the batch; `valid_to` = max(lengths)
  zeroes x, e and the first hidden layer of each stack at t >= valid_to.

Parameters are a dict keyed by the reference's state_dict names
(`layout`).  `product` is the only multiply of a weight and an
activation; its operands go through `rnd` (precision.py) in the forward
and in the backward, so a control computes the whole step in its
precision."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .precision import exact

Rounding = Callable[[torch.Tensor], torch.Tensor]


class Dims(NamedTuple):
    C: int   # input_dim
    U: int   # u_dim
    H1: int  # hidden_dim (and the decoder's width D)
    H2: int  # hidden_dim2
    K: int   # regimes
    HP: int  # trans_hidden


def dims_of(model: dict) -> Dims:
    """Dims from a configuration's `model` section."""
    return Dims(model["input_dim"], model["u_dim"], model["hidden_dim"],
                model["hidden_dim2"], model["K"], model["trans_hidden"])


def layout(d: Dims) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """(name, shape, init, fan_in) of every parameter, in state_dict
    order.  init: "uniform" is U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's
    default for Conv1d and Linear), "normal" N(0, 1) (nn.Embedding),
    "zeros"."""
    D = d.H1
    out = []

    def conv(name, o, i, k):
        out.append((f"{name}.weight", (o, i, k), "uniform", i * k))
        out.append((f"{name}.bias", (o,), "uniform", i * k))

    def lin(name, o, i):
        out.append((f"{name}.weight", (o, i), "uniform", i))
        out.append((f"{name}.bias", (o,), "uniform", i))

    conv("encoder.conv1", d.H1, d.C, 3)
    conv("encoder.conv2", d.H2, d.H1, 3)
    conv("encoder.to_logits", d.K, d.H2, 1)
    out.append(("prior.log_prior", (d.K,), "zeros", 0))
    lin("prior.transition_net.0", d.HP, d.U)
    lin("prior.transition_net.2", d.K * d.K, d.HP)
    out.append(("decoder.embeddings.weight", (d.K, D), "normal", 0))
    conv("decoder.conv1", D, D, 3)
    conv("decoder.conv2", D, D, 3)
    conv("decoder.to_params", 2 * d.C, D, 1)
    return out


class _Product(torch.autograd.Function):
    """out (B, O, T) = w (O, I) @ h (B, I, T), both operands rounded by
    rnd, and in the backward the incoming gradient and the other operand
    rounded alike."""

    @staticmethod
    def forward(ctx, w, h, rnd):
        wr, hr = rnd(w), rnd(h)
        ctx.save_for_backward(wr, hr)
        ctx.rnd = rnd
        return torch.einsum("oi,bit->bot", wr, hr)

    @staticmethod
    def backward(ctx, g):
        wr, hr = ctx.saved_tensors
        gr = ctx.rnd(g)
        return (torch.einsum("bot,bit->oi", gr, hr),
                torch.einsum("oi,bot->bit", wr, gr), None)


def product(w: torch.Tensor, h: torch.Tensor, rnd: Rounding = exact
            ) -> torch.Tensor:
    if rnd is exact:
        return torch.einsum("oi,bit->bot", w, h)
    return _Product.apply(w, h, rnd)


def conv_same(w: torch.Tensor, b: torch.Tensor, h: torch.Tensor,
              rnd: Rounding = exact) -> torch.Tensor:
    """Conv1d with zero SAME padding, stride 1: a sum of one product a
    tap.  w (O, I, k), h (B, I, T) -> (B, O, T)."""
    k = w.shape[-1]
    T = h.shape[-1]
    hp = F.pad(h, (k // 2, k // 2))
    out = product(w[:, :, 0], hp[:, :, 0:T], rnd)
    for j in range(1, k):
        out = out + product(w[:, :, j], hp[:, :, j:j + T], rnd)
    return out + b[None, :, None]


def _tmask(T: int, valid_to, device) -> torch.Tensor:
    return (torch.arange(T, device=device) < valid_to).float()[None, None]


def encode(p: Dict[str, torch.Tensor], x: torch.Tensor, valid_to=None,
           rnd: Rounding = exact) -> torch.Tensor:
    """Regime logits (B, K, T)."""
    if valid_to is not None:
        m = _tmask(x.shape[-1], valid_to, x.device)
        x = x * m
    h = torch.relu(conv_same(p["encoder.conv1.weight"],
                             p["encoder.conv1.bias"], x, rnd))
    if valid_to is not None:
        h = h * m
    h = torch.relu(conv_same(p["encoder.conv2.weight"],
                             p["encoder.conv2.bias"], h, rnd))
    return conv_same(p["encoder.to_logits.weight"],
                     p["encoder.to_logits.bias"], h, rnd)


def prior(p: Dict[str, torch.Tensor], u: torch.Tensor,
          rnd: Rounding = exact) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (B, U, T) -> (log_pi (K,), log_A (B, T, K, K))."""
    B, _, T = u.shape
    K = p["prior.log_prior"].shape[0]
    h = torch.relu(product(p["prior.transition_net.0.weight"], u, rnd)
                   + p["prior.transition_net.0.bias"][None, :, None])
    logits = product(p["prior.transition_net.2.weight"], h, rnd) \
        + p["prior.transition_net.2.bias"][None, :, None]
    logits = logits.permute(0, 2, 1).reshape(B, T, K, K)
    return (torch.log_softmax(p["prior.log_prior"], dim=0),
            torch.log_softmax(logits, dim=-1))


def decode(p: Dict[str, torch.Tensor], q: torch.Tensor, valid_to=None,
           rnd: Rounding = exact) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B, K, T) -> (mu, logvar), each (B, C, T)."""
    e = product(p["decoder.embeddings.weight"].t(), q, rnd)
    if valid_to is not None:
        m = _tmask(e.shape[-1], valid_to, e.device)
        e = e * m
    h = torch.relu(conv_same(p["decoder.conv1.weight"],
                             p["decoder.conv1.bias"], e, rnd))
    if valid_to is not None:
        h = h * m
    h = torch.relu(conv_same(p["decoder.conv2.weight"],
                             p["decoder.conv2.bias"], h, rnd))
    out = conv_same(p["decoder.to_params.weight"],
                    p["decoder.to_params.bias"], h, rnd)
    C = out.shape[1] // 2
    return out[:, :C], out[:, C:]


def neg_elbo(p: Dict[str, torch.Tensor], x: torch.Tensor, u: torch.Tensor,
             lengths: torch.Tensor, beta: float,
             rnd: Rounding = exact) -> torch.Tensor:
    """The masked negative ELBO of a padded batch, x (B, C, T), u (B, U,
    T), lengths (B,)."""
    B, C, T = x.shape
    mask = (torch.arange(T, device=x.device)[None, :]
            < lengths[:, None]).float()
    valid_to = lengths.max()
    log_pi, log_A = prior(p, u, rnd)
    log_q = torch.log_softmax(encode(p, x, valid_to, rnd), dim=1)
    q = torch.exp(log_q)
    mu, logvar = decode(p, q, valid_to, rnd)
    var = torch.clamp(torch.exp(logvar), min=1e-8)
    nll = 0.5 * (torch.log(2.0 * math.pi * var) + (mu - x) ** 2 / var)
    recon = (nll * mask[:, None, :]).sum() / torch.clamp(mask.sum() * C,
                                                          min=1.0)
    init = (q[:, :, 0] * log_pi[None, :]).sum(dim=1)
    trans = torch.einsum("bit,bjt,btij->bt", q[:, :, :-1], q[:, :, 1:],
                         log_A[:, 1:])
    trans = (trans * (mask[:, 1:] * mask[:, :-1])).sum(dim=1)
    prior_loss = -(init + trans).mean()
    entropy = (-(q * log_q).sum(dim=1) * mask).sum() / B
    return recon + beta * (prior_loss - entropy)


def loss_and_grads(p: Dict[str, torch.Tensor], x, u, lengths, beta,
                   rnd: Rounding = exact
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, gradients keyed like p) by autograd."""
    leaves = {n: t.detach().clone().requires_grad_(True)
              for n, t in p.items()}
    with torch.enable_grad():
        loss = neg_elbo(leaves, x, u, lengths, beta, rnd)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def posterior(p: Dict[str, torch.Tensor], x: torch.Tensor,
              rnd: Rounding = exact) -> torch.Tensor:
    """Mean-field regime posterior q (B, K, T) = softmax(encode(x)), over
    the whole T (the entry takes no lengths)."""
    return torch.softmax(encode(p, x, None, rnd), dim=1)


def evidence(p: Dict[str, torch.Tensor], x: torch.Tensor, u: torch.Tensor,
             lengths: torch.Tensor, rnd: Rounding = exact):
    """(log_pi (K,), log_A (B, T, K, K), log_obs (B, T, K)): the HMM's
    inputs, the encoder bounded at max(lengths)."""
    log_pi, log_A = prior(p, u, rnd)
    logits = encode(p, x, lengths.max(), rnd)
    return log_pi, log_A, torch.log_softmax(logits, dim=1).transpose(1, 2)
