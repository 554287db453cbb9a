"""Exact HMM inference in log space: forward, backward, marginals, Viterbi.

Counterpart of vqvaehmm_tpu/ops/hmm.py in plain PyTorch.  The JAX
recursions are `lax.scan`s outside any Pallas kernel; here they are
Python loops over time, and its `lax.associative_scan`s are doubling
scans (log2 T rounds of one batched log-space product each).  The Viterbi
decode on a CUDA tensor runs in the hand-written kernel of
ops/fused_viterbi.py instead; `viterbi` below is its plain version.

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


def pairwise_marginals(log_pi, log_A, log_obs,
                       lengths: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """xi (B, T-1, K, K) = p(z_t=i, z_{t+1}=j | x) for t = 0..T-2."""
    return smoothing(log_pi, log_A, log_obs, lengths).xi


class SmoothingResult(NamedTuple):
    gamma: torch.Tensor           # (B, T, K) smoothed marginals
    xi: torch.Tensor              # (B, T-1, K, K) pairwise marginals
    log_likelihood: torch.Tensor  # (B,)


def smoothing(log_pi, log_A, log_obs,
              lengths: Optional[torch.Tensor] = None) -> SmoothingResult:
    """All smoothing statistics from one forward and one backward pass.

    With lengths, xi is zeroed at invalid pairs (t >= L-1): the masked
    identity transition would otherwise put gamma_{L-1} on the diagonal of
    every padded step, and a sum of xi over time would overcount
    self-transitions.  gamma rows at padded steps repeat the last valid
    row."""
    B, T, K = log_obs.shape
    log_Am, log_obsm = _mask_inputs(_as_time_varying(log_A, B, T), log_obs,
                                    lengths)
    fwd = forward(log_pi, log_Am, log_obsm, None)
    log_beta = backward(log_Am, log_obsm, None)
    gamma = torch.softmax(fwd.log_alpha + log_beta, dim=-1)
    log_xi = (fwd.log_alpha[:, :-1, :, None] + log_Am[:, 1:]
              + (log_obsm + log_beta)[:, 1:, None, :])
    xi = torch.exp(log_xi - fwd.log_likelihood[:, None, None, None])
    if lengths is not None:
        valid = torch.arange(T, device=log_obs.device)[None, :] \
            < lengths.to(log_obs.device)[:, None]
        pair_valid = valid[:, 1:] & valid[:, :-1]
        xi = xi * pair_valid[:, :, None, None]
    return SmoothingResult(gamma, xi, fwd.log_likelihood)


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


# ---------------------------------------------------------------------------
# Associative-scan (parallel-in-time) variants
# ---------------------------------------------------------------------------


def _prefix_products(ops: torch.Tensor, reduce) -> torch.Tensor:
    """Inclusive prefix products of the (B, N, K, K) operators along N
    under the semiring product P[i, j] = reduce_k a[i, k] + b[k, j], as a
    doubling scan: round s combines element t with element t - s."""
    N = ops.shape[1]
    s = 1
    while s < N:
        left, right = ops[:, :-s], ops[:, s:]
        comb = reduce(left[..., :, :, None] + right[..., None, :, :], -2)
        ops = torch.cat([ops[:, :s], comb], dim=1)
        s *= 2
    return ops


def _max(a: torch.Tensor, dim: int) -> torch.Tensor:
    return torch.max(a, dim=dim).values


def forward_assoc(log_pi, log_A, log_obs,
                  lengths: Optional[torch.Tensor] = None) -> ForwardResult:
    """Forward pass as a prefix scan of the operators M_t[i, j] =
    log_A_t[i, j] + log_obs_t[j]: O(log T) depth, parallel in T."""
    B, T, K = log_obs.shape
    log_A, log_obs = _mask_inputs(_as_time_varying(log_A, B, T), log_obs,
                                  lengths)
    alpha0 = log_pi[None, :] + log_obs[:, 0]
    if T == 1:
        return ForwardResult(alpha0[:, None],
                             torch.logsumexp(alpha0, dim=-1))
    prefix = _prefix_products(log_A[:, 1:] + log_obs[:, 1:, None, :],
                              torch.logsumexp)
    rest = torch.logsumexp(alpha0[:, None, :, None] + prefix, dim=2)
    log_alpha = torch.cat([alpha0[:, None], rest], dim=1)
    return ForwardResult(log_alpha, torch.logsumexp(log_alpha[:, -1], dim=-1))


def viterbi_assoc_scores(log_pi, log_A, log_obs,
                         lengths: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Max-plus prefix scan giving the Viterbi deltas (B, T, K) and the MAP
    score (B,), with no backtrace."""
    B, T, K = log_obs.shape
    log_A, log_obs = _mask_inputs(_as_time_varying(log_A, B, T), log_obs,
                                  lengths)
    delta0 = log_pi[None, :] + log_obs[:, 0]
    if T == 1:
        return delta0[:, None], _max(delta0, -1)
    prefix = _prefix_products(log_A[:, 1:] + log_obs[:, 1:, None, :], _max)
    rest = _max(delta0[:, None, :, None] + prefix, 2)
    deltas = torch.cat([delta0[:, None], rest], dim=1)
    return deltas, _max(deltas[:, -1], -1)


def _categorical(log_p: torch.Tensor, generator: torch.Generator
                 ) -> torch.Tensor:
    """One draw a row of (B, K) log-probabilities, by the inverse CDF of a
    uniform drawn on the generator's device (so a seed gives the same path
    wherever log_p lives)."""
    p = torch.softmax(log_p, dim=-1)
    r = torch.rand((p.shape[0], 1), generator=generator,
                   device=generator.device).to(p.device)
    idx = (torch.cumsum(p, dim=-1) < r).sum(dim=-1)
    return idx.clamp(max=p.shape[-1] - 1)


def sample(generator: torch.Generator, log_pi, log_A, num_steps: int,
           batch: int = 1) -> torch.Tensor:
    """Ancestral sampling of state paths: (batch, num_steps) int32, drawn
    from an explicit generator."""
    log_A = _as_time_varying(log_A, batch, num_steps)
    K = log_pi.shape[-1]
    z = _categorical(log_pi.expand(batch, K), generator)
    path = [z]
    for t in range(1, num_steps):
        rows = torch.gather(log_A[:, t], 1,
                            z[:, None, None].expand(batch, 1, K))[:, 0]
        z = _categorical(rows, generator)
        path.append(z)
    return torch.stack(path, dim=1).to(torch.int32)
