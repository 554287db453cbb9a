"""The VAE-HMM regime model as a torch.nn.Module.

Counterpart of vqvaehmm_tpu/models/vae_hmm.py, with the same semantics:

* Encoder: Conv1d(k=3, SAME) + ReLU x2 -> 1x1 Conv to K regime logits,
  x (B, C, T) -> logits (B, K, T).
* Prior: learnable initial logits, and an MLP u_t -> K x K row
  log-softmax giving time-varying transitions log_A (B, T, K, K).
* Decoder: soft codebook lookup e = q^T E, Conv1d stack -> (mu, logvar).
* compute_loss: the masked negative ELBO with the reference's three
  normalisations (forward only).

Parameter names are the reference's own state_dict keys
(`encoder.conv1.weight`, `prior.transition_net.0.weight`, ...), so a
reference `.pt` file loads with `load_state_dict` as it is, and
data/checkpoint.py maps the JAX package's parameter pytree onto them.
Public tensors keep the JAX package's layouts: (B, C, T), and log_A
(B, T, K, K).

On a CUDA device the inference paths run in hand-written CUDA kernels:
the serving forward `infer_forward` (ops/fused_infer.py), the encoder
behind `posterior` and `encode(fused=None)` (ops/fused_encoder.py), the
evidence of the three exact modes (ops/fused_decode.py) and the Viterbi
recursion (ops/fused_viterbi.py).  On the CPU each runs its plain
version; the plain version runs on the card only when asked with
`fused=False` / `use_kernel=False`.  The kernels' outputs carry no
gradient: `compute_loss` and `forward` take the plain, differentiable
convolutions on every device.  torch's own exp/log/log_softmax are used
throughout: the JAX package's ops/precise.py exists only for the TPU
build's fast math.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.config import ModelConfig
from ..core.masking import length_mask, pairwise_mask
from ..ops import hmm as hmm_ops
from ..ops import nn as ops
from ..ops.fused_decode import fused_evidence
from ..ops.fused_encoder import fused_encode
from ..ops.fused_infer import fused_forward
from ..ops.fused_viterbi import viterbi_fused


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.conv1 = nn.Conv1d(cfg.input_dim, cfg.hidden_dim, 3, padding=1,
                               device=device)
        self.conv2 = nn.Conv1d(cfg.hidden_dim, cfg.hidden_dim2, 3,
                               padding=1, device=device)
        self.to_logits = nn.Conv1d(cfg.hidden_dim2, cfg.K, 1, device=device)


class Prior(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.log_prior = nn.Parameter(torch.zeros(cfg.K, device=device))
        self.transition_net = nn.Sequential(
            nn.Linear(cfg.u_dim, cfg.trans_hidden, device=device),
            nn.ReLU(),
            nn.Linear(cfg.trans_hidden, cfg.K * cfg.K, device=device))


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        # latent dim == hidden_dim (the reference wires
        # Decoder(K, hidden_dim, hidden_dim, input_dim))
        D = cfg.hidden_dim
        self.embeddings = nn.Embedding(cfg.K, D, device=device)
        self.conv1 = nn.Conv1d(D, D, 3, padding=1, device=device)
        self.conv2 = nn.Conv1d(D, D, 3, padding=1, device=device)
        self.to_params = nn.Conv1d(D, cfg.input_dim * 2, 1, device=device)


def _time_bound_mask(T: int, valid_to, device) -> torch.Tensor:
    """Float mask zeroing t >= valid_to: (1, 1, T) for a scalar valid_to,
    (B, 1, T) for a per-sequence (B,) vector.  It makes fixed-length
    padding equal to the reference's batch-max padding (see
    vqvaehmm_tpu/models/vae_hmm.py::_time_bound_mask)."""
    vt = torch.as_tensor(valid_to, device=device)
    t = torch.arange(T, device=device)
    if vt.dim() == 0:
        return (t < vt).to(torch.float32)[None, None, :]
    return (t[None, :] < vt[:, None]).to(torch.float32)[:, None, :]


class VAEHMM(nn.Module):
    """Mean-field VAE with an input-conditioned HMM prior over K regimes."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.u_dim is None:
            raise ValueError("Stationary transitions not implemented in "
                             "VAEHMM; pass u_dim")
        if cfg.compute_dtype != "float32":
            raise NotImplementedError(
                f"compute_dtype={cfg.compute_dtype!r}: the port serves "
                "float32 only; bf16 serving is still to be ported "
                "(ROADMAP.md, queue 1)")
        self.cfg = cfg
        self.encoder = Encoder(cfg, device)
        # registered by hand: the submodule's state_dict name "prior" is
        # also the name of the prior() method, which add_module refuses
        self._modules["prior"] = Prior(cfg, device)
        self.decoder = Decoder(cfg, device)
        if cfg.matmul_precision == "highest":
            # parity mode: full float32 on the card (cuDNN convolutions
            # default to TF32, which keeps about three decimal digits).
            # These flags are process-wide, not per model: once a
            # "highest" model is built, every later matmul and convolution
            # in the process runs in full float32, and nothing here turns
            # them back on.  The plain versions of the CUDA kernels
            # (compute_loss plus autograd for the fused train step, the
            # serving forward) are held to them at float32 tolerances, so
            # they depend on the flags being off.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """torch.nn-default init (kaiming-uniform weights and biases,
        N(0, 1) embeddings, zero initial logits), drawn from `generator`."""
        enc, dec = self.encoder, self.decoder
        for conv in (enc.conv1, enc.conv2, enc.to_logits,
                     dec.conv1, dec.conv2, dec.to_params):
            ops.init_conv1d_(conv, generator)
        net = self.prior_module.transition_net
        ops.init_linear_(net[0], generator)
        ops.init_linear_(net[2], generator)
        ops.init_embedding_(dec.embeddings, generator)
        with torch.no_grad():
            self.prior_module.log_prior.zero_()

    @property
    def prior_module(self) -> Prior:
        return self._modules["prior"]

    @property
    def device(self) -> torch.device:
        return self.encoder.conv1.weight.device

    # ------------------------------------------------------------------
    # Sub-modules
    # ------------------------------------------------------------------

    def encode(self, x: torch.Tensor, valid_to=None,
               fused: Optional[bool] = None) -> torch.Tensor:
        """x (B, C, T) -> regime logits (B, K, T).  valid_to (scalar or
        (B,)) zeroes x and the first hidden layer at t >= valid_to.

        fused=None runs the whole stack as one CUDA kernel for a CUDA
        tensor (ops/fused_encoder.py; inference only: it raises where grad
        mode is on and x or the weights require grad) and the plain
        convolutions for a CPU tensor; fused=False is the plain,
        differentiable stack on any device; fused=True on a CPU tensor
        raises."""
        if fused is None:
            fused = x.is_cuda
        if fused:
            return fused_encode(self, x, valid_to=valid_to, use_kernel=True)
        enc = self.encoder
        T = x.shape[-1]
        if valid_to is not None:
            tmask = _time_bound_mask(T, valid_to, x.device)
            x = x * tmask
        h = torch.relu(ops.conv1d_same(enc.conv1.weight, enc.conv1.bias, x))
        if valid_to is not None:
            h = h * tmask
        h = torch.relu(ops.conv1d_same(enc.conv2.weight, enc.conv2.bias, h))
        return ops.conv1d_same(enc.to_logits.weight, enc.to_logits.bias, h)

    def prior(self, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """u (B, U, T) or (B, T, U) -> (log_pi (K,), log_A (B, T, K, K)).
        A 3-D u whose dim 1 equals u_dim is read as (B, U, T)."""
        cfg = self.cfg
        if u is None:
            raise ValueError("u required for non-stationary transitions")
        if u.dim() == 3 and u.shape[1] == cfg.u_dim:
            u = u.transpose(1, 2)
        B, T, _ = u.shape
        net = self.prior_module.transition_net
        logits = ops.mlp2(net[0], net[2], u)
        log_A = torch.log_softmax(logits.reshape(B, T, cfg.K, cfg.K), dim=-1)
        log_pi = torch.log_softmax(self.prior_module.log_prior, dim=0)
        return log_pi, log_A

    def decode(self, q: torch.Tensor, valid_to=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """q (B, K, T) -> Gaussian (mu, logvar), each (B, C, T).  valid_to
        zeroes e and the first hidden layer at t >= valid_to."""
        dec = self.decoder
        e = torch.einsum("bkt,kd->bdt", q, dec.embeddings.weight)
        if valid_to is not None:
            tmask = _time_bound_mask(e.shape[-1], valid_to, e.device)
            e = e * tmask
        h = torch.relu(ops.conv1d_same(dec.conv1.weight, dec.conv1.bias, e))
        if valid_to is not None:
            h = h * tmask
        h = torch.relu(ops.conv1d_same(dec.conv2.weight, dec.conv2.bias, h))
        out = ops.conv1d_same(dec.to_params.weight, dec.to_params.bias, h)
        mid = out.shape[1] // 2
        return out[:, :mid, :], out[:, mid:, :]

    # ------------------------------------------------------------------
    # Loss / forward
    # ------------------------------------------------------------------

    def compute_loss(self, x: torch.Tensor, u: torch.Tensor,
                     lengths: torch.Tensor, beta: float = 1.0
                     ) -> torch.Tensor:
        """Masked negative ELBO (vqvaehmm_tpu VAEHMM.compute_loss):
        recon / max(mask.sum()*C, 1) + beta * (prior - entropy)."""
        if lengths is None:
            raise ValueError("lengths required")
        B, C, T = x.shape
        mask = length_mask(lengths, T)
        valid_to = lengths.max()
        log_pi, log_A = self.prior(u)
        log_q = torch.log_softmax(
            self.encode(x, valid_to=valid_to, fused=False), dim=1)
        q = torch.exp(log_q)
        mu, logvar = self.decode(q, valid_to=valid_to)

        var = torch.clamp(torch.exp(logvar), min=1e-8)
        nll = 0.5 * (torch.log(2.0 * math.pi * var) + (mu - x) ** 2 / var)
        maskf = mask.to(x.dtype)
        denom = torch.clamp(maskf.sum() * C, min=1.0)
        recon_loss = (nll * maskf[:, None, :]).sum() / denom

        init_loss = (q[:, :, 0] * log_pi[None, :]).sum(dim=1)
        trans = torch.einsum("bit,bjt,btij->bt",
                             q[:, :, :-1], q[:, :, 1:], log_A[:, 1:])
        tmask = pairwise_mask(mask).to(x.dtype)
        trans_loss = (trans * tmask).sum(dim=1)
        prior_loss = -(init_loss + trans_loss).mean()

        entropy = -(q * log_q).sum(dim=1)
        entropy = (entropy * maskf).sum() / B
        return recon_loss + beta * (prior_loss - entropy)

    def forward(self, x: torch.Tensor):
        """((mu, logvar), q), the reference's forward (differentiable)."""
        q = torch.softmax(self.encode(x, fused=False), dim=1)
        mu, logvar = self.decode(q)
        return (mu, logvar), q

    def sample(self, u: torch.Tensor, generator: torch.Generator,
               sample_obs: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Generative ancestral rollout: (states (B, T) int32, x (B, C, T)).
        A regime path is drawn from the input-conditioned prior chain
        p(z | u) and decoded through the Gaussian emission model (a one-hot
        state makes the soft codebook lookup that regime's embedding row).
        sample_obs=False returns the emission mean instead of a draw.  All
        draws come from `generator`, on its device."""
        log_pi, log_A = self.prior(u)
        B, T = log_A.shape[0], log_A.shape[1]
        states = hmm_ops.sample(generator, log_pi, log_A, T, batch=B)
        q = torch.nn.functional.one_hot(
            states.long(), self.cfg.K).to(torch.float32).transpose(1, 2)
        mu, logvar = self.decode(q)
        if not sample_obs:
            return states, mu
        noise = torch.randn(mu.shape, generator=generator,
                            device=generator.device).to(mu.device)
        return states, mu + torch.exp(0.5 * logvar) * noise

    def posterior(self, x: torch.Tensor,
                  fused: Optional[bool] = None) -> torch.Tensor:
        """Mean-field regime posterior q (B, K, T) = softmax(encode(x)),
        the backtester's posterior extraction.  fused: see encode."""
        return torch.softmax(self.encode(x, fused=fused), dim=1)

    def infer_forward(self, x: torch.Tensor, valid_to=None,
                      use_kernel: Optional[bool] = None):
        """The serving forward (mu, logvar, q): encode -> softmax ->
        decode, with valid_to a scalar or a per-sequence (B,) vector.  On a
        CUDA tensor it is one kernel launch (ops/fused_infer.py)."""
        return fused_forward(self, x, valid_to=valid_to,
                             use_kernel=use_kernel)

    # ------------------------------------------------------------------
    # Exact HMM inference
    # ------------------------------------------------------------------

    def _hmm_evidence(self, x: torch.Tensor,
                      lengths: Optional[torch.Tensor]) -> torch.Tensor:
        """Encoder evidence (B, T, K) in plain PyTorch, the encoder bounded
        at max(lengths)."""
        valid_to = lengths.max() if lengths is not None else None
        logits = self.encode(x, valid_to=valid_to, fused=False)
        return torch.log_softmax(logits, dim=1).transpose(1, 2)

    def _evidence_inputs(self, x: torch.Tensor, u: torch.Tensor,
                         lengths: Optional[torch.Tensor],
                         use_kernel: Optional[bool]):
        """(log_pi, log_A, log_obs) for the exact-inference paths: one
        kernel launch for CUDA tensors (ops/fused_decode.py; inference
        only, as encode's kernel is), prior() and _hmm_evidence() for CPU
        tensors or with use_kernel=False."""
        return fused_evidence(self, x, u, lengths, use_kernel=use_kernel)

    def smoothed_posterior(self, x: torch.Tensor, u: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None,
                           use_kernel: Optional[bool] = None
                           ) -> torch.Tensor:
        """Forward-backward regime posterior (B, K, T)."""
        log_pi, log_A, log_obs = self._evidence_inputs(x, u, lengths,
                                                       use_kernel)
        gamma = hmm_ops.posterior_marginals(log_pi, log_A, log_obs, lengths)
        return gamma.transpose(1, 2)

    def filtered_posterior(self, x: torch.Tensor, u: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None,
                           use_kernel: Optional[bool] = None
                           ) -> torch.Tensor:
        """Filtering regime posterior (B, K, T): evidence up to t only
        (the encoder itself looks 2 steps ahead)."""
        log_pi, log_A, log_obs = self._evidence_inputs(x, u, lengths,
                                                       use_kernel)
        alpha = hmm_ops.filtered_marginals(log_pi, log_A, log_obs, lengths)
        return alpha.transpose(1, 2)

    def viterbi_decode(self, x: torch.Tensor, u: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
        """MAP regime path (B, T) int32 under the prior's transitions.  On
        CUDA tensors the evidence is one kernel launch and the decode
        another, for any T (ops/fused_decode.py, ops/fused_viterbi.py);
        the one-kernel decode from raw (x, u) is
        ops.fused_decode.fused_viterbi_states."""
        log_pi, log_A, log_obs = self._evidence_inputs(x, u, lengths,
                                                       use_kernel)
        return viterbi_fused(log_pi, log_A, log_obs, lengths,
                             use_kernel=use_kernel).states
