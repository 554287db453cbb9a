"""Exact HMM inference in log space: forward, backward, marginals, Viterbi.

Counterpart of vqvaehmm_tpu/ops/hmm.py:43-229 in plain PyTorch.  The JAX
recursions are `lax.scan`s outside any Pallas kernel; here they are
Python loops over time.  The Viterbi decode on a CUDA tensor runs in
the hand-written kernel of ops/fused_viterbi.py instead; `viterbi` below
is its plain version.

Conventions (those of the JAX module):
  log_pi  : (K,)          initial state log-probs
  log_A   : (B, T, K, K)  row-normalised; log_A[:, t, i, j] is the
                          transition i->j into step t (index 0 unused),
                          or (T, K, K) shared across the batch, or (K, K)
  log_obs : (B, T, K)     per-step emission log-likelihoods
  lengths : (B,) optional; padded steps become identity transitions with
            zero observation, so rows t < L are exact for ragged batches
            and marginal rows at t >= L repeat the last valid row.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def _as_time_varying(log_A: torch.Tensor, B: int, T: int) -> torch.Tensor:
    """Broadcast (K,K) / (T,K,K) / (B,T,K,K) to (B,T,K,K) as a view.

    A 3-D input is (T,K,K) shared across the batch by contract; a
    per-batch stationary (B,K,K) is rejected (when B == T it would
    silently change meaning)."""
    K = log_A.shape[-1]
    if log_A.dim() == 2:
        return log_A.expand(B, T, K, K)
    if log_A.dim() == 3:
        if log_A.shape[0] != T:
            raise ValueError(
                f"3-D log_A must be (T,K,K) with T={T}, got "
                f"{tuple(log_A.shape)}; per-batch stationary (B,K,K) is "
                "not supported — tile it to (B,T,K,K) explicitly")
        return log_A.expand(B, T, K, K)
    if tuple(log_A.shape[:2]) != (B, T):
        raise ValueError(
            f"4-D log_A must be (B,T,K,K)=({B},{T},K,K), got "
            f"{tuple(log_A.shape)}")
    return log_A


def _mask_inputs(log_A: torch.Tensor, log_obs: torch.Tensor,
                 lengths: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Make padded steps inert: identity transition, zero observation."""
    if lengths is None:
        return log_A, log_obs
    B, T, K = log_obs.shape
    dev = log_obs.device
    valid = torch.arange(T, device=dev)[None, :] < lengths.to(dev)[:, None]
    log_obs = torch.where(valid[:, :, None], log_obs,
                          torch.zeros((), dtype=log_obs.dtype, device=dev))
    eye = torch.full((K, K), float("-inf"), dtype=log_A.dtype, device=dev)
    eye.fill_diagonal_(0.0)
    log_A = torch.where(valid[:, :, None, None], log_A, eye)
    return log_A, log_obs


class ForwardResult(NamedTuple):
    log_alpha: torch.Tensor       # (B, T, K)
    log_likelihood: torch.Tensor  # (B,)


def forward(log_pi, log_A, log_obs,
            lengths: Optional[torch.Tensor] = None) -> ForwardResult:
    """Log-space forward recursion."""
    B, T, K = log_obs.shape
    log_A, log_obs = _mask_inputs(_as_time_varying(log_A, B, T), log_obs,
                                  lengths)
    alpha = log_pi[None, :] + log_obs[:, 0]
    alphas = [alpha]
    for t in range(1, T):
        alpha = torch.logsumexp(alpha[:, :, None] + log_A[:, t], dim=1) \
            + log_obs[:, t]
        alphas.append(alpha)
    return ForwardResult(torch.stack(alphas, dim=1),
                         torch.logsumexp(alpha, dim=-1))


def backward(log_A, log_obs,
             lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """beta_t(i) = log p(x_{t+1:T} | z_t=i), (B, T, K)."""
    B, T, K = log_obs.shape
    log_A, log_obs = _mask_inputs(_as_time_varying(log_A, B, T), log_obs,
                                  lengths)
    beta = torch.zeros((B, K), dtype=log_obs.dtype, device=log_obs.device)
    betas = [beta]
    for t in range(T - 1, 0, -1):
        beta = torch.logsumexp(
            log_A[:, t] + (log_obs[:, t] + beta)[:, None, :], dim=2)
        betas.append(beta)
    return torch.stack(betas[::-1], dim=1)


def posterior_marginals(log_pi, log_A, log_obs,
                        lengths: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Smoothed marginals gamma (B, T, K) = p(z_t | x_{1:L})."""
    fwd = forward(log_pi, log_A, log_obs, lengths)
    log_beta = backward(log_A, log_obs, lengths)
    return torch.softmax(fwd.log_alpha + log_beta, dim=-1)


def filtered_marginals(log_pi, log_A, log_obs,
                       lengths: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Causal marginals (B, T, K) = p(z_t | x_{1:t})."""
    return torch.softmax(forward(log_pi, log_A, log_obs, lengths).log_alpha,
                         dim=-1)


class ViterbiResult(NamedTuple):
    states: torch.Tensor  # (B, T) int32 MAP path (frozen past L-1)
    score: torch.Tensor   # (B,) log p(z*, x)


def viterbi(log_pi, log_A, log_obs,
            lengths: Optional[torch.Tensor] = None) -> ViterbiResult:
    """Max-product decode with backtrace, in the sequential order of
    vqvaehmm_tpu/ops/hmm.py:200-229: scores = delta_i + A_ij, max over i
    with the first maximum winning ties, then + obs_j."""
    B, T, K = log_obs.shape
    log_A, log_obs = _mask_inputs(_as_time_varying(log_A, B, T), log_obs,
                                  lengths)
    delta = log_pi[None, :] + log_obs[:, 0]
    backptrs = []
    for t in range(1, T):
        scores = delta[:, :, None] + log_A[:, t]        # (B, K_prev, K)
        best, arg = torch.max(scores, dim=1)
        backptrs.append(arg)
        delta = best + log_obs[:, t]
    score, last = torch.max(delta, dim=-1)
    states = [last]
    for bp in reversed(backptrs):
        last = torch.gather(bp, 1, last[:, None])[:, 0]
        states.append(last)
    return ViterbiResult(torch.stack(states[::-1], dim=1).to(torch.int32),
                         score)
