"""Stationary hidden Markov model with exact inference, and Baum-Welch EM.

Counterpart of vqvaehmm_tpu/models/hmm.py: construction from initial,
transition and emission distributions, `mean()`, `log_prob()`, the
posterior marginals and mode, ancestral sampling, and EM over discrete
code sequences (`fit_categorical_em`, the fit of the VQ family's regime
HMM), over fixed evidence (`fit_transitions_em`) and over diagonal
Gaussians (`fit_gaussian_em`).

All inference runs on the recursions of ops/hmm.py.  `posterior_mode` on
a CUDA tensor decodes in the hand-written Viterbi kernel
(ops/fused_viterbi.py), as the JAX method takes its Pallas decode on a
TPU; `use_kernel=False` is the plain recursion.

EM in the JAX package is a `lax.scan` under `vmap` over the restarts (no
Pallas kernel); here an iteration is one call of ops/hmm.py's smoothing,
a Python loop over time, with the restarts folded into its batch (row
r * B + b is sequence b under restart r's parameters), so a fit costs
n_iters passes whatever the number of restarts.  JAX draws the restarts'
initial parameters from `jax.random`, a stream torch cannot reproduce:
they are drawn here from `np.random.default_rng(seed)`, or handed in
through `init=` (which is how the tests give both packages one start).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import hmm as ops
from ..ops.fused_viterbi import viterbi_fused

_LOG_2PI = math.log(2 * math.pi)


class GaussianEmission(NamedTuple):
    loc: torch.Tensor    # (K,) or (K, D)
    scale: torch.Tensor  # same shape

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T) scalars or (B, T, D) -> (B, T, K)."""
        loc, scale = self.loc, self.scale
        if loc.dim() == 1:
            z = (x[..., None] - loc) / scale
            return -0.5 * z * z - torch.log(scale) - 0.5 * _LOG_2PI
        z = (x[..., None, :] - loc) / scale  # (B, T, K, D)
        return (-0.5 * z * z - torch.log(scale) - 0.5 * _LOG_2PI).sum(-1)

    def mean_per_state(self) -> torch.Tensor:
        return self.loc


class CategoricalEmission(NamedTuple):
    logits: torch.Tensor  # (K, V) observation log-probs of each state

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T) integer observations -> (B, T, K)."""
        log_B = torch.log_softmax(self.logits, dim=-1)
        return log_B.T[x.long()]  # a (V, K) lookup

    def mean_per_state(self) -> torch.Tensor:
        probs = torch.softmax(self.logits, dim=-1)
        v = torch.arange(self.logits.shape[-1], dtype=probs.dtype,
                         device=probs.device)
        return (probs * v).sum(-1)


class HiddenMarkovModel:
    """Stationary HMM over K states, from plain arrays of probabilities;
    `num_steps` fixes the horizon for the defaults of `mean()` and
    `sample()`.  Its tensors live on the emission's device."""

    def __init__(self, initial_probs, transition_probs, emission,
                 num_steps: Optional[int] = None):
        device = emission[0].device if emission is not None else None
        self.log_pi = torch.log(torch.as_tensor(
            initial_probs, dtype=torch.float32).to(device))
        self.log_A = torch.log(torch.as_tensor(
            transition_probs, dtype=torch.float32).to(device))
        self.emission = emission
        self.num_steps = num_steps
        self.K = self.log_pi.shape[0]

    # -- state-marginal utilities ------------------------------------

    def state_marginals(self, num_steps: Optional[int] = None
                        ) -> torch.Tensor:
        """(T, K) marginal state distributions pi @ A^t."""
        T = num_steps or self.num_steps
        A = torch.exp(self.log_A)
        p = torch.exp(self.log_pi)
        ps = [p]
        for _ in range(T - 1):
            p = p @ A
            ps.append(p)
        return torch.stack(ps)

    def mean(self, num_steps: Optional[int] = None) -> torch.Tensor:
        """E[x_t] at each step: (T,) or (T, D)."""
        return self.state_marginals(num_steps) \
            @ self.emission.mean_per_state()

    # -- inference ----------------------------------------------------

    def _log_obs(self, x) -> Tuple[torch.Tensor, bool]:
        """Emission log-probs (B, T, K); unbatched sequences are taken
        too."""
        x = torch.as_tensor(x, device=self.log_pi.device)
        if isinstance(self.emission, CategoricalEmission) or \
                self.emission.loc.dim() == 1:
            unbatched = x.dim() == 1   # a scalar or an integer a step
        else:
            unbatched = x.dim() == 2   # observations are (T, D)
        if unbatched:
            x = x[None]
        return self.emission.log_prob(x), unbatched

    def log_prob(self, x, lengths=None) -> torch.Tensor:
        """Sequence log-likelihood."""
        log_obs, squeeze = self._log_obs(x)
        ll = ops.forward(self.log_pi, self.log_A, log_obs, lengths
                         ).log_likelihood
        return ll[0] if squeeze else ll

    def posterior_marginals(self, x, lengths=None) -> torch.Tensor:
        log_obs, squeeze = self._log_obs(x)
        g = ops.posterior_marginals(self.log_pi, self.log_A, log_obs,
                                    lengths)
        return g[0] if squeeze else g

    def posterior_mode(self, x, lengths=None,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
        """Viterbi MAP state path, int32.  use_kernel=None decodes in the
        CUDA kernel where the model lives on a CUDA device (K past the
        kernel's bound raises there) and in the plain recursion on the
        CPU; use_kernel=False is the plain recursion anywhere."""
        log_obs, squeeze = self._log_obs(x)
        v = viterbi_fused(self.log_pi, self.log_A, log_obs, lengths,
                          use_kernel=use_kernel)
        return v.states[0] if squeeze else v.states

    def sample(self, generator: torch.Generator,
               num_steps: Optional[int] = None, batch: int = 1):
        """Ancestral sample of (states, observations), drawn from an
        explicit generator."""
        T = num_steps or self.num_steps
        states = ops.sample(generator, self.log_pi, self.log_A, T, batch)
        s = states.long()
        if self.emission is None:          # a bare chain observes nothing
            return states, None
        if isinstance(self.emission, CategoricalEmission):
            logits = self.emission.logits[s]                 # (B, T, V)
            obs = ops._categorical(logits.reshape(-1, logits.shape[-1]),
                                   generator).reshape(s.shape)
        else:
            loc = self.emission.loc[s]
            scale = self.emission.scale[s]
            noise = torch.randn(loc.shape, generator=generator,
                                device=generator.device).to(loc.device)
            obs = loc + scale * noise
        return states, obs


class EMResult(NamedTuple):
    model: HiddenMarkovModel
    log_likelihoods: torch.Tensor  # (n_iters,) total data log-likelihood


def _valid_mask(B: int, T: int, lengths, device) -> torch.Tensor:
    if lengths is None:
        return torch.ones((B, T), dtype=torch.bool, device=device)
    return torch.arange(T, device=device)[None, :] \
        < torch.as_tensor(lengths, device=device)[:, None]


def _normalised_log(w: torch.Tensor) -> torch.Tensor:
    return torch.log(w / w.sum(-1, keepdim=True))


def _fold(log_pi, log_A, B: int, T: int):
    """(R, K), (R, K, K) -> the (R*B, K) and (R*B, T, K, K) views that run
    every restart's chain over every sequence in one batch."""
    R, K = log_pi.shape
    return (log_pi[:, None, :].expand(R, B, K).reshape(R * B, K),
            log_A[:, None, None].expand(R, B, T, K, K).reshape(
                R * B, T, K, K))


def _tile_lengths(lengths, R: int, device):
    if lengths is None:
        return None
    return torch.as_tensor(lengths, device=device).repeat(R)


def fit_categorical_em(codes, K: int, V: int, n_iters: int = 50,
                       seed: int = 0, lengths=None,
                       pseudocount: float = 1e-3, n_init: int = 4,
                       sticky: Optional[float] = None,
                       init=None) -> EMResult:
    """Baum-Welch EM for an HMM with categorical emissions over code
    indices.  codes: (B, T) integers in [0, V), on the device the fit runs
    on.

    EM is multimodal: `n_init` restarts run in one batch and the best
    final log-likelihood wins.  sticky: when set (e.g. 0.95), every second
    restart (the even ones) starts its transition matrix at
    sticky * I + (1 - sticky) / K instead of its random draw, which biases
    those chains toward slow switching; the best final log-likelihood
    still wins across all restarts.

    init: optional (log_pi (R, K), log_A (R, K, K), log_B (R, K, V)), the
    restarts' random starting points (the sticky rule is applied on top);
    without it they are Dirichlet draws from np.random.default_rng(seed).
    """
    codes = torch.as_tensor(codes).long()
    dev = codes.device
    B, T = codes.shape
    valid = _valid_mask(B, T, lengths, dev)
    onehot = F.one_hot(codes, V).to(torch.float32) * valid[..., None]

    if init is None:
        rng = np.random.default_rng(seed)
        draws = [(rng.dirichlet(np.ones(K)),
                  rng.dirichlet(np.full(K, 2.0), size=K),
                  rng.dirichlet(np.ones(V), size=K)) for _ in range(n_init)]
        init = tuple(torch.log(torch.from_numpy(
            np.stack(a).astype(np.float32))) for a in zip(*draws))
    log_pi, log_A, log_Bm = (torch.as_tensor(a, dtype=torch.float32)
                             .to(dev) for a in init)
    R = log_pi.shape[0]
    if sticky is not None:
        A_sticky = sticky * torch.eye(K, device=dev) \
            + (1.0 - sticky) / K * torch.ones((K, K), device=dev)
        even = (torch.arange(R, device=dev) % 2) == 0
        log_A = torch.where(even[:, None, None], torch.log(A_sticky), log_A)
    lens = _tile_lengths(lengths, R, dev)

    lls = []
    for _ in range(n_iters):
        # (R, V, K) looked up at the codes: (R, B, T, K)
        log_obs = log_Bm.transpose(1, 2)[:, codes].reshape(R * B, T, K)
        sm = ops.smoothing(*_fold(log_pi, log_A, B, T), log_obs, lens)
        # ops.smoothing zeroes xi at invalid pairs (ragged batches)
        gamma = sm.gamma.reshape(R, B, T, K)
        xi = sm.xi.reshape(R, B, T - 1, K, K)
        gamma_m = gamma * valid[None, ..., None]
        pi_new = gamma[:, :, 0].sum(1) + pseudocount
        A_new = xi.sum((1, 2)) + pseudocount
        B_new = torch.einsum("rbtk,btv->rkv", gamma_m, onehot) + pseudocount
        log_pi, log_A, log_Bm = (_normalised_log(pi_new),
                                 _normalised_log(A_new),
                                 _normalised_log(B_new))
        lls.append(sm.log_likelihood.reshape(R, B).sum(1))
    lls = torch.stack(lls, dim=1)                            # (R, n_iters)
    best = int(torch.argmax(lls[:, -1]))
    model = HiddenMarkovModel(torch.exp(log_pi[best]),
                              torch.exp(log_A[best]),
                              CategoricalEmission(log_Bm[best]),
                              num_steps=T)
    return EMResult(model, lls[best])


def fit_transitions_em(log_obs: torch.Tensor, n_iters: int = 50,
                       lengths=None, pseudocount: float = 1e-3,
                       init_stickiness: float = 0.9
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EM over (pi, A) only, with the emission model held fixed: pass
    log p(x_t | z_t = k) as `log_obs` (B, T, K), from any per-step model,
    and get back (log_pi, log_A, log_likelihoods (n_iters,)).  Decode
    afterwards with ops.hmm.viterbi or posterior_marginals on the same
    log_obs."""
    log_obs = torch.as_tensor(log_obs, dtype=torch.float32)
    dev = log_obs.device
    B, T, K = log_obs.shape
    A0 = torch.full((K, K), (1.0 - init_stickiness) / max(K - 1, 1),
                    device=dev)
    A0.fill_diagonal_(init_stickiness if K > 1 else 1.0)
    log_pi = torch.log(torch.full((K,), 1.0 / K, device=dev))
    log_A = torch.log(A0)
    valid0 = _valid_mask(B, T, lengths, dev)[:, :1]
    lls = []
    for _ in range(n_iters):
        sm = ops.smoothing(log_pi, log_A, log_obs, lengths)
        pi_new = (sm.gamma[:, 0] * valid0).sum(0) + pseudocount
        A_new = sm.xi.sum((0, 1)) + pseudocount  # xi zeroed at invalid pairs
        log_pi, log_A = _normalised_log(pi_new), _normalised_log(A_new)
        lls.append(sm.log_likelihood.sum())
    return log_pi, log_A, torch.stack(lls)


def fit_gaussian_em(x: torch.Tensor, K: int, n_iters: int = 50,
                    seed: int = 0, lengths=None, min_scale: float = 1e-3,
                    n_init: int = 4, init=None) -> EMResult:
    """Baum-Welch EM for an HMM with diagonal-Gaussian emissions.  x:
    (B, T) or (B, T, D) observations.  Restarts in one batch, the best
    final log-likelihood wins.

    init: optional (log_pi (R, K), log_A (R, K, K), loc (R, K, D)), the
    restarts' starting points; without it the first two are Dirichlet
    draws and the means normal draws around the data's mean, from
    np.random.default_rng(seed)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    dev = x.device
    if x.dim() == 2:
        x = x[..., None]
    B, T, D = x.shape
    valid = _valid_mask(B, T, lengths, dev)
    validf = valid.to(torch.float32)
    flat = x.reshape(-1, D)
    vf = validf.reshape(-1, 1)
    data_mean = (flat * vf).sum(0) / validf.sum()
    data_std = torch.sqrt(((flat - data_mean) ** 2 * vf).sum(0)
                          / validf.sum())

    if init is None:
        rng = np.random.default_rng(seed)
        draws = [(np.log(rng.dirichlet(np.ones(K))),
                  np.log(rng.dirichlet(np.full(K, 2.0), size=K)),
                  rng.normal(size=(K, D))) for _ in range(n_init)]
        log_pi, log_A, noise = (torch.from_numpy(
            np.stack(a).astype(np.float32)).to(dev) for a in zip(*draws))
        loc = data_mean + data_std * noise
    else:
        log_pi, log_A, loc = (torch.as_tensor(a, dtype=torch.float32)
                              .to(dev) for a in init)
    R = log_pi.shape[0]
    scale = (data_std + min_scale).expand(R, K, D)
    lens = _tile_lengths(lengths, R, dev)

    lls = []
    for _ in range(n_iters):
        z = (x[None, :, :, None, :] - loc[:, None, None]) \
            / scale[:, None, None]                           # (R, B, T, K, D)
        log_obs = (-0.5 * z * z - torch.log(scale)[:, None, None]
                   - 0.5 * _LOG_2PI).sum(-1).reshape(R * B, T, K)
        sm = ops.smoothing(*_fold(log_pi, log_A, B, T), log_obs, lens)
        gamma = sm.gamma.reshape(R, B, T, K)
        xi = sm.xi.reshape(R, B, T - 1, K, K)
        g = gamma * validf[None, ..., None]
        nk = torch.clamp(g.sum((1, 2)), min=1e-6)            # (R, K)
        pi_new = gamma[:, :, 0].sum(1) + 1e-3
        A_new = xi.sum((1, 2)) + 1e-3
        loc = torch.einsum("rbtk,btd->rkd", g, x) / nk[..., None]
        var = torch.einsum("rbtk,rbtkd->rkd", g,
                           (x[None, :, :, None, :]
                            - loc[:, None, None]) ** 2) / nk[..., None]
        scale = torch.sqrt(var) + min_scale
        log_pi, log_A = _normalised_log(pi_new), _normalised_log(A_new)
        lls.append(sm.log_likelihood.reshape(R, B).sum(1))
    lls = torch.stack(lls, dim=1)
    best = int(torch.argmax(lls[:, -1]))
    one = D == 1
    model = HiddenMarkovModel(
        torch.exp(log_pi[best]), torch.exp(log_A[best]),
        GaussianEmission(loc[best][:, 0] if one else loc[best],
                         scale[best][:, 0] if one else scale[best]),
        num_steps=T)
    return EMResult(model, lls[best])
