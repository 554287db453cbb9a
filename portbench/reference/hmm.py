"""The Viterbi yardstick, in float64: the best path score of each row
under the HMM's inputs, and the score of a given path.

A path is judged by its score under the reference's own inputs: the
best score less the path's is 0 for a best path and grows with the
log-probability it gives away, so two best paths of a tie both read 0."""

from __future__ import annotations

import torch


def best_score(log_pi: torch.Tensor, log_A: torch.Tensor,
               log_obs: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """max over paths of log_pi[z0] + log_obs[0, z0] + sum over 0 < t <
    length of log_A[t, z(t-1), z(t)] + log_obs[t, z(t)]: (B,) float64.
    log_A (B, T, K, K), log_obs (B, T, K), lengths (B,) >= 1."""
    log_A, log_obs = log_A.double(), log_obs.double()
    lengths = lengths.to(log_obs.device)
    delta = log_pi.double()[None, :] + log_obs[:, 0]
    for t in range(1, log_obs.shape[1]):
        step = (delta[:, :, None] + log_A[:, t]).max(dim=1).values \
            + log_obs[:, t]
        delta = torch.where((t < lengths)[:, None], step, delta)
    return delta.max(dim=1).values


def path_score(log_pi: torch.Tensor, log_A: torch.Tensor,
               log_obs: torch.Tensor, states: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """The score of the paths `states` (B, T), read up to each row's
    length: (B,) float64."""
    z = states.to(log_obs.device).long()
    B, T, _ = log_obs.shape
    lengths = lengths.to(log_obs.device)
    valid = torch.arange(T, device=log_obs.device)[None, :] < lengths[:, None]
    obs = torch.gather(log_obs.double(), 2, z[:, :, None])[:, :, 0]
    trans = log_A.double()[:, 1:].gather(
        2, z[:, :-1, None, None].expand(-1, -1, 1, log_A.shape[-1]))
    trans = trans[:, :, 0].gather(2, z[:, 1:, None])[:, :, 0]
    return (log_pi.double()[z[:, 0]] + (obs * valid).sum(dim=1)
            + (trans * valid[:, 1:]).sum(dim=1))


def best_path(log_pi: torch.Tensor, log_A: torch.Tensor,
              log_obs: torch.Tensor, lengths: torch.Tensor,
              rnd=None) -> torch.Tensor:
    """A best path (B, T) of each row, by backtrace, its state held past
    the row's length.  rnd (precision.py) rounds the running scores after
    every step, as a scan kept in that precision would (a control's)."""
    log_A, log_obs = log_A.double(), log_obs.double()
    B, T, K = log_obs.shape
    lengths = lengths.to(log_obs.device)
    stay = torch.arange(K, device=log_obs.device)[None, :].expand(B, K)
    delta = log_pi.double()[None, :] + log_obs[:, 0]
    back = []
    for t in range(1, T):
        best, arg = (delta[:, :, None] + log_A[:, t]).max(dim=1)
        live = (t < lengths)[:, None]
        delta = torch.where(live, best + log_obs[:, t], delta)
        if rnd is not None:
            delta = rnd(delta.float()).double()
        back.append(torch.where(live, arg, stay))
    last = delta.argmax(dim=1)
    states = [last]
    for arg in reversed(back):
        last = arg.gather(1, last[:, None])[:, 0]
        states.append(last)
    return torch.stack(states[::-1], dim=1)
