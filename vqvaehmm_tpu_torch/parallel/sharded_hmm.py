"""Sequence-parallel HMM forward: the time axis over the ranks of a mesh
(counterpart of vqvaehmm_tpu/parallel/sharded_hmm.py).

1. each rank runs a local prefix scan of the (K, K) log-matmul operators
   of its T / n steps (ops/hmm.py::_prefix_products);
2. the ranks all-gather their shards' total operators, one (B, K, K) each;
3. each rank takes the exclusive log-matmul prefix of the totals before
   its shard and applies it to its local prefixes, which gives the global
   forward recursion on its steps.

For one long sequence (a backtest panel of tens of thousands of steps)
whose recursion one device's memory or latency bounds.
"""

from __future__ import annotations

import torch

from ..ops.hmm import ForwardResult, _as_time_varying, _prefix_products
from .mesh import Mesh


def _log_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(exp(a) @ exp(b)) over the last two axes."""
    return torch.logsumexp(a[..., :, :, None] + b[..., None, :, :], dim=-2)


def forward_sharded(log_pi: torch.Tensor, log_A: torch.Tensor,
                    log_obs: torch.Tensor, mesh: Mesh) -> ForwardResult:
    """The forward pass with T split over the mesh's ranks.

    log_pi (K,), log_A (B, T, K, K) or broadcastable, log_obs (B, T, K):
    the whole arrays, the same on every rank.  Returns this rank's shard
    of log_alpha, steps [r T / n, (r + 1) T / n), and the global
    log-likelihood (B,), the same on every rank.  T must divide over the
    ranks.  No `lengths`, as in the JAX package: padded decoding stays on
    the unsharded path."""
    B, T, K = log_obs.shape
    if T % mesh.size:
        raise ValueError(f"T={T} must divide over {mesh.size} shards")
    steps = mesh.rows(T)
    log_A = _as_time_varying(log_A, B, T)
    ops = log_A[:, steps] + log_obs[:, steps, None, :]
    eye = torch.full((K, K), float("-inf"), dtype=ops.dtype,
                     device=ops.device)
    eye.fill_diagonal_(0.0)
    if mesh.rank == 0:
        # step 0 has no transition: alpha_0 is the initial row
        ops = torch.cat([eye.expand(B, 1, K, K), ops[:, 1:]], dim=1)
    local = _prefix_products(ops, torch.logsumexp)       # (B, T/n, K, K)
    totals = mesh.all_gather(local[:, -1][None])          # (n, B, K, K)
    prefix = eye.expand(B, K, K)
    for r in range(mesh.rank):
        prefix = _log_matmul(prefix, totals[r])
    alpha0 = log_pi[None, :] + log_obs[:, 0]
    log_alpha = torch.logsumexp(
        alpha0[:, None, :, None] + _log_matmul(prefix[:, None], local),
        dim=2)
    # the whole product, the last rank's own last prefix on every rank
    last = eye.expand(B, K, K)
    for r in range(mesh.size - 1):
        last = _log_matmul(last, totals[r])
    last = _log_matmul(last, totals[-1])
    ll = torch.logsumexp(torch.logsumexp(alpha0[:, :, None] + last, dim=1),
                         dim=-1)
    return ForwardResult(log_alpha, ll)
