"""The true VQ-VAE with an HMM over its discrete codes, as a
torch.nn.Module.

Counterpart of vqvaehmm_tpu/models/vqvae_hmm.py:

  z_e = encoder(x)                       # continuous latents a time step
  z_q, idx = quantize(z_e, codebook)     # nearest code (ops/vq.py)
  z_q_st = z_e + sg(z_q - z_e)           # straight-through
  x_hat = decoder(z_q_st)
  loss = MSE + commitment + codebook
  hmm = fit_categorical_em(all indices)  # models/hmm.py
  sample: hmm.sample -> codebook lookup -> decoder

The parameter names map one to one onto the JAX package's pytree
(`encoder.conv1.weight` <-> params["encoder"]["conv1"]["weight"],
`codebook` <-> params["codebook"]); data/checkpoint.py crosses them.

On a CUDA tensor `codes` and `fit_hmm` find the nearest code in a
hand-written CUDA kernel of ops/vq.py, and `quantize` (and so
`compute_loss`) runs the whole straight-through quantizer, forward and
backward, as one kernel launch each, reading z_e in its own (B, D, T)
layout; on a CPU tensor, and with `use_kernel=False`, their plain
versions.  (The JAX package keeps its Pallas kernel behind
`VQVAEConfig.use_pallas`, off by default, because off a TPU it would run
interpreted.)  The quantizer's kernels sum across blocks in a fixed order
and the convolutions are matrix products with a fixed summation order,
so training on the card is deterministic without
`torch.backends.cudnn.deterministic`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.masking import length_mask
from ..ops import nn as ops
from ..ops.vq import VQResult, quantize_st, vq_nearest
from .hmm import (CategoricalEmission, EMResult, HiddenMarkovModel,
                  fit_categorical_em)


@dataclass(frozen=True)
class VQVAEConfig:
    input_dim: int = 5
    hidden_dim: int = 64
    hidden_dim2: int = 32
    num_codes: int = 8       # codebook size
    latent_dim: int = 16     # code dimensionality
    commitment_beta: float = 0.25


class VQVAELoss(NamedTuple):
    total: torch.Tensor
    recon: torch.Tensor
    commitment: torch.Tensor
    codebook: torch.Tensor
    # per-code assignment histogram over the valid positions, (num_codes,)
    # integers, free from the loss's own quantization; the training loop
    # reads it to find and restart dead codes (gradient VQ only ever moves
    # assigned codes, so a code that starts dead stays dead)
    counts: torch.Tensor


class _Stack(nn.Module):
    """Conv1d(k=3) + ReLU, Conv1d(k=3) + ReLU, Conv1d(k=1), each computed
    as one matrix product over shifted copies of its input
    (ops/nn.py::conv1d_same_matmul): the weight gradients then sum in a
    fixed order, so a training run on the card repeats bit for bit."""

    def __init__(self, dims, last: str, device=None):
        super().__init__()
        a, b, c, d = dims
        self.conv1 = nn.Conv1d(a, b, 3, padding=1, device=device)
        self.conv2 = nn.Conv1d(b, c, 3, padding=1, device=device)
        self.add_module(last, nn.Conv1d(c, d, 1, device=device))

    def convs(self):
        return tuple(self.children())     # conv1, conv2, the 1x1 `last`

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1, c2, c3 = self.convs()
        h = torch.relu(ops.conv1d_same_matmul(c1.weight, c1.bias, x))
        h = torch.relu(ops.conv1d_same_matmul(c2.weight, c2.bias, h))
        return ops.conv1d_same_matmul(c3.weight, c3.bias, h)


class VQVAEHMM(nn.Module):
    """Conv encoder -> a vector quantization a time step -> conv decoder,
    plus an HMM over the code sequence fit by Baum-Welch EM."""

    def __init__(self, cfg: VQVAEConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Stack((cfg.input_dim, cfg.hidden_dim,
                               cfg.hidden_dim2, cfg.latent_dim),
                              "to_latent", device)
        self.codebook = nn.Parameter(torch.empty(
            (cfg.num_codes, cfg.latent_dim), device=device))
        self.decoder = _Stack((cfg.latent_dim, cfg.hidden_dim,
                               cfg.hidden_dim, cfg.input_dim),
                              "to_out", device)
        # full float32 on the card, as models/vae_hmm.py sets it in parity
        # mode, for matrix products and for cuDNN (whose convolutions
        # default to TF32, should a caller run this stack through them):
        # the card's losses are held against the CPU's at float32
        # tolerances, and a TF32 latent flips codes.  The flags are
        # process-wide.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """torch.nn-default convolutions and an N(0, 0.5^2) codebook, drawn
        from `generator` on the CPU in the JAX init's order (encoder,
        codebook, decoder)."""
        for conv in self.encoder.convs():
            ops.init_conv1d_(conv, generator)
        draw = torch.empty(self.codebook.shape).normal_(generator=generator)
        with torch.no_grad():
            self.codebook.copy_(draw * 0.5)
        for conv in self.decoder.convs():
            ops.init_conv1d_(conv, generator)

    @property
    def device(self) -> torch.device:
        return self.codebook.device

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, T) -> continuous latents z_e (B, D, T)."""
        return self.encoder(x)

    def quantize(self, z_e: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 use_kernel: Optional[bool] = None) -> VQResult:
        """z_e (B, D, T) -> straight-through z_q (B, D, T) and indices
        (B, T).  mask: optional (B, T) validity; the two VQ losses are
        then means over the valid positions only."""
        return quantize_st(z_e, self.codebook, self.cfg.commitment_beta,
                           use_kernel=use_kernel, mask=mask,
                           channels_first=True)

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        """z_q (B, D, T) -> x_hat (B, C, T)."""
        return self.decoder(z_q)

    def codes(self, x: torch.Tensor,
              use_kernel: Optional[bool] = None) -> torch.Tensor:
        """Discrete code-index sequences (B, T) int32: the nearest-code
        lookup alone, without gradients."""
        with torch.no_grad():
            return vq_nearest(self.encode(x), self.codebook,
                              channels_first=True, use_kernel=use_kernel)[1]

    def compute_loss(self, x: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None,
                     use_kernel: Optional[bool] = None) -> VQVAELoss:
        """Masked MSE + commitment + codebook loss."""
        z_e = self.encode(x)
        vmask = (length_mask(lengths, x.shape[-1])
                 if lengths is not None else None)
        # all three terms are masked, not the reconstruction alone:
        # unmasked VQ means would pull codebook vectors toward padding
        # latents and shift the weighting with the padding fraction
        res = self.quantize(z_e, mask=vmask, use_kernel=use_kernel)
        x_hat = self.decode(res.quantized)
        if lengths is not None:
            m = vmask.to(x.dtype)[:, None, :]
            # the exact integer count (a float32 mask sum cannot hold a
            # large count exactly)
            denom = torch.clamp(lengths.sum().to(torch.float32)
                                * x.shape[1], min=1.0)
            recon = (((x_hat - x) ** 2) * m).sum() / denom
        else:
            recon = ((x_hat - x) ** 2).mean()
        total = recon + res.commitment_loss + res.codebook_loss
        onehot = F.one_hot(res.indices.long(), self.cfg.num_codes)
        if vmask is not None:
            onehot = onehot * vmask[..., None]
        return VQVAELoss(total, recon, res.commitment_loss,
                         res.codebook_loss, onehot.sum((0, 1)))

    def fit_hmm(self, x: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                n_iters: int = 50, seed: int = 0) -> EMResult:
        """Fit the regime HMM over the code indices by Baum-Welch."""
        return fit_categorical_em(self.codes(x), K=self.cfg.num_codes,
                                  V=self.cfg.num_codes, n_iters=n_iters,
                                  seed=seed, lengths=lengths)

    def sample(self, hmm: HiddenMarkovModel, generator: torch.Generator,
               seq_len: int, batch: int = 1) -> torch.Tensor:
        """Ancestral generation: hmm.sample -> codebook lookup -> decoder.
        The HMM's emission maps states to code indices."""
        states, obs = hmm.sample(generator, num_steps=seq_len, batch=batch)
        if isinstance(hmm.emission, CategoricalEmission):
            codes = obs.long()             # the emitted symbols are codes
        elif hmm.emission is None:
            codes = states.long()          # a bare chain: states as codes
        else:
            # a Gaussian emission's continuous observations would cut to
            # meaningless codebook indices
            raise ValueError(
                "VQVAEHMM.sample needs a categorical-emission (or "
                "emission-free) HMM whose symbols index the codebook; "
                f"got {type(hmm.emission).__name__}")
        with torch.no_grad():
            z_q = self.codebook[codes.to(self.device)]        # (B, T, D)
            return self.decode(z_q.transpose(1, 2))
