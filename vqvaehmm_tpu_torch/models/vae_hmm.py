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

On a CUDA device the inference paths of a float32 model run in
hand-written CUDA kernels: the serving forward `infer_forward`
(ops/fused_infer.py), the encoder behind `posterior` and
`encode(fused=None)` (ops/fused_encoder.py), the evidence of the three
exact modes (ops/fused_decode.py) and the Viterbi recursion
(ops/fused_viterbi.py).  On the CPU each runs its plain version; the
plain version runs on the card when asked with `fused=False` /
`use_kernel=False`, and for a call that autograd would record (grad mode
on and x, u or a weight of the stage requiring grad), as the JAX
package's auto-dispatch steps aside for a differentiating caller
(ops/fused_infer.py::kernel_route); a kernel forced with `fused=True` /
`use_kernel=True` then raises.  The kernels' outputs carry no gradient:
`compute_loss` and `forward` take the plain, differentiable convolutions
on every device.  torch's own exp/log/log_softmax are used throughout:
the JAX package's ops/precise.py exists only for the TPU build's fast
math.

`compute_dtype="bfloat16"` (the throughput configuration) is the JAX
package's XLA path in bfloat16: parameters and inputs cast to bfloat16
inside `encode`, `prior` and `decode`, so activations, ReLUs and masks
are bfloat16; logits, (mu, logvar) and the transition logits back to
float32; log_pi from the float32 log_prior; parameters, and so the
optimizer's state, float32.  The float32 kernels A, 8, 10 and 11 step
aside for such a model (`use_kernel=None` takes the plain path on every
device, as the JAX package routes it around its kernels); the Viterbi
recursion (kernel B) takes its float32 evidence.  `bf16_operands=True`
is the other bfloat16 arithmetic, that of the train kernel's bfloat16
mode: float32 activations, both operands of every product rounded to
bfloat16 (ops/nn.py::bf16_matmul).

That is also the arithmetic of the inference kernels' bfloat16-operand
mode, the TPU kernels' `highest=False`: a float32 model whose
matmul_precision is not "highest" runs kernels A, 8, 10 and 11 in it on a
CUDA tensor (ops/fused_train.py::infer_bf16_mode), and their wrappers'
plain route there (`use_kernel=False`) computes with
`bf16_operands=True`.  `encode(fused=False)`, `compute_loss` and
`forward` keep the model's own products on every device.
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
from ..utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        if cfg.compute_dtype not in _DTYPES:
            raise ValueError(f"unknown compute_dtype {cfg.compute_dtype!r};"
                             f" expected one of {sorted(_DTYPES)}")
        self.cfg = cfg
        self.compute_dtype = _DTYPES[cfg.compute_dtype]
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

    def _products(self, bf16_operands: bool):
        """(conv(layer, h), linear(layer, h), lookup(E, q), cast(t)) of the
        plain path.  float32: the layers as they are.  bfloat16: the
        parameters cast inside, each product rounded to bfloat16 and its
        bias added in bfloat16 (rounded again), as the JAX package's XLA
        path rounds.  bf16_operands: float32 with both operands of each
        product rounded to bfloat16."""
        if bf16_operands:
            return (lambda m, h: ops.conv1d_same_bf16(m.weight, m.bias, h),
                    lambda m, h: ops.linear_bf16(m.weight, m.bias, h),
                    lambda E, q: ops.bf16_matmul(E.t(), q),
                    lambda a: a)
        if self.compute_dtype == torch.float32:
            return (lambda m, h: ops.conv1d_same(m.weight, m.bias, h),
                    lambda m, h: ops.linear(m.weight, m.bias, h),
                    lambda E, q: torch.einsum("bkt,kd->bdt", q, E),
                    lambda a: a)
        bf = torch.bfloat16
        return (lambda m, h: ops.conv1d_same(m.weight.to(bf), None, h)
                + m.bias.to(bf)[None, :, None],
                lambda m, h: ops.linear(m.weight.to(bf), None, h)
                + m.bias.to(bf),
                lambda E, q: torch.einsum("bkt,kd->bdt", q, E.to(bf)),
                lambda a: a.to(bf))

    # ------------------------------------------------------------------
    # Sub-modules
    # ------------------------------------------------------------------

    def encode(self, x: torch.Tensor, valid_to=None,
               fused: Optional[bool] = None,
               bf16_operands: bool = False) -> torch.Tensor:
        """x (B, C, T) -> regime logits (B, K, T), float32.  valid_to
        (scalar or (B,)) zeroes x and the first hidden layer at
        t >= valid_to.

        fused=None runs the whole stack of a float32 model as one CUDA
        kernel for a CUDA tensor (ops/fused_encoder.py; inference only: a
        call that autograd records takes the plain stack, in the kernel
        mode's arithmetic) and the plain convolutions otherwise;
        fused=False is the plain, differentiable stack on any device;
        fused=True on a CPU tensor or a bfloat16 model, or under
        autograd, raises.  bf16_operands: see the module's docstring
        (plain stack only).  A `model.encode` span (utils/profiling.py)."""
        with span("model.encode"):
            if fused is not False:
                return fused_encode(self, x, valid_to=valid_to,
                                    use_kernel=fused)
            return self._encode_stack(x, valid_to, bf16_operands)

    def _encode_stack(self, x: torch.Tensor, valid_to=None,
                      bf16_operands: bool = False) -> torch.Tensor:
        """The plain, differentiable stack of encode(fused=False)."""
        enc = self.encoder
        conv, _, _, cast = self._products(bf16_operands)
        x = cast(x)
        T = x.shape[-1]
        if valid_to is not None:
            tmask = _time_bound_mask(T, valid_to, x.device).to(x.dtype)
            x = x * tmask
        h = torch.relu(conv(enc.conv1, x))
        if valid_to is not None:
            h = h * tmask
        h = torch.relu(conv(enc.conv2, h))
        return conv(enc.to_logits, h).float()

    def prior(self, u: torch.Tensor, bf16_operands: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """u (B, U, T) or (B, T, U) -> (log_pi (K,), log_A (B, T, K, K)),
        float32.  A 3-D u whose dim 1 equals u_dim is read as (B, U, T)."""
        cfg = self.cfg
        if u is None:
            raise ValueError("u required for non-stationary transitions")
        if u.dim() == 3 and u.shape[1] == cfg.u_dim:
            u = u.transpose(1, 2)
        B, T, _ = u.shape
        net = self.prior_module.transition_net
        _, linear, _, cast = self._products(bf16_operands)
        logits = linear(net[2], torch.relu(linear(net[0], cast(u)))).float()
        log_A = torch.log_softmax(logits.reshape(B, T, cfg.K, cfg.K), dim=-1)
        # the float32 log_prior: K values used in no product
        log_pi = torch.log_softmax(self.prior_module.log_prior, dim=0)
        return log_pi, log_A

    def decode(self, q: torch.Tensor, valid_to=None,
               bf16_operands: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """q (B, K, T) -> Gaussian (mu, logvar), each (B, C, T), float32.
        valid_to zeroes e and the first hidden layer at t >= valid_to."""
        dec = self.decoder
        conv, _, lookup, cast = self._products(bf16_operands)
        e = lookup(dec.embeddings.weight, cast(q))
        if valid_to is not None:
            tmask = _time_bound_mask(e.shape[-1], valid_to,
                                     e.device).to(e.dtype)
            e = e * tmask
        h = torch.relu(conv(dec.conv1, e))
        if valid_to is not None:
            h = h * tmask
        h = torch.relu(conv(dec.conv2, h))
        out = conv(dec.to_params, h).float()
        mid = out.shape[1] // 2
        return out[:, :mid, :], out[:, mid:, :]

    # ------------------------------------------------------------------
    # Loss / forward
    # ------------------------------------------------------------------

    def compute_loss(self, x: torch.Tensor, u: torch.Tensor,
                     lengths: torch.Tensor, beta: float = 1.0,
                     bf16_operands: bool = False,
                     norm: Optional[Tuple[int, int, int]] = None
                     ) -> torch.Tensor:
        """Masked negative ELBO (vqvaehmm_tpu VAEHMM.compute_loss):
        recon / max(mask.sum()*C, 1) + beta * (prior - entropy).
        bf16_operands: the train kernel's bfloat16 arithmetic (module
        docstring).  norm = (valid_to, mask_total, B_total) of a global
        batch these rows are a shard of stands in for max(lengths),
        mask.sum() and B, so that the shards' losses (and gradients) sum
        to the global batch's: the train kernel's global normalisation,
        for a rank of a data-parallel step."""
        if lengths is None:
            raise ValueError("lengths required")
        B, C, T = x.shape
        mask = length_mask(lengths, T)
        valid_to = lengths.max() if norm is None else norm[0]
        log_pi, log_A = self.prior(u, bf16_operands)
        log_q = torch.log_softmax(
            self.encode(x, valid_to=valid_to, fused=False,
                        bf16_operands=bf16_operands), dim=1)
        q = torch.exp(log_q)
        mu, logvar = self.decode(q, valid_to=valid_to,
                                 bf16_operands=bf16_operands)

        var = torch.clamp(torch.exp(logvar), min=1e-8)
        nll = 0.5 * (torch.log(2.0 * math.pi * var) + (mu - x) ** 2 / var)
        maskf = mask.to(x.dtype)
        total = maskf.sum() if norm is None else torch.full(
            (), float(norm[1]), dtype=x.dtype, device=x.device)
        denom = torch.clamp(total * C, min=1.0)
        recon_loss = (nll * maskf[:, None, :]).sum() / denom

        init_loss = (q[:, :, 0] * log_pi[None, :]).sum(dim=1)
        trans = torch.einsum("bit,bjt,btij->bt",
                             q[:, :, :-1], q[:, :, 1:], log_A[:, 1:])
        tmask = pairwise_mask(mask).to(x.dtype)
        trans_loss = (trans * tmask).sum(dim=1)
        prior_loss = -(init_loss + trans_loss).mean() if norm is None \
            else -(init_loss + trans_loss).sum() / norm[2]

        entropy = -(q * log_q).sum(dim=1)
        entropy = (entropy * maskf).sum() / (B if norm is None else norm[2])
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
        the backtester's posterior extraction.  fused: see encode.  A
        `score.posterior` span."""
        with span("score.posterior"):
            return torch.softmax(self.encode(x, fused=fused), dim=1)

    def infer_forward(self, x: torch.Tensor, valid_to=None,
                      use_kernel: Optional[bool] = None, mesh=None):
        """The serving forward (mu, logvar, q): encode -> softmax ->
        decode, with valid_to a scalar or a per-sequence (B,) vector.  On a
        CUDA tensor it is one kernel launch (ops/fused_infer.py).

        mesh (parallel/mesh.py): bulk scoring over the ranks.  x (and a
        per-sequence valid_to) is the whole batch on every rank; each rank
        runs the forward on its rows, one launch, and an all-gather returns
        the whole (mu, logvar, q) on every rank.  A row has no
        cross-sequence arithmetic, so no other collective is needed; B
        must divide over the ranks."""
        if mesh is None:
            return fused_forward(self, x, valid_to=valid_to,
                                 use_kernel=use_kernel)
        rows = mesh.rows(x.shape[0])
        if valid_to is not None and torch.as_tensor(valid_to).dim():
            valid_to = valid_to[rows]
        parts = fused_forward(self, x[rows], valid_to=valid_to,
                              use_kernel=use_kernel)
        return tuple(mesh.all_gather(p) for p in parts)

    # ------------------------------------------------------------------
    # Exact HMM inference
    # ------------------------------------------------------------------

    def _hmm_evidence(self, x: torch.Tensor,
                      lengths: Optional[torch.Tensor],
                      bf16_operands: bool = False) -> torch.Tensor:
        """Encoder evidence (B, T, K) in plain PyTorch, the encoder bounded
        at max(lengths); bf16_operands: see the module's docstring."""
        valid_to = lengths.max() if lengths is not None else None
        logits = self.encode(x, valid_to=valid_to, fused=False,
                             bf16_operands=bf16_operands)
        return torch.log_softmax(logits, dim=1).transpose(1, 2)

    def _evidence_inputs(self, x: torch.Tensor, u: torch.Tensor,
                         lengths: Optional[torch.Tensor],
                         use_kernel: Optional[bool]):
        """(log_pi, log_A, log_obs) for the exact-inference paths: one
        kernel launch for CUDA tensors (ops/fused_decode.py; inference
        only, as encode's kernel is), prior() and _hmm_evidence() for CPU
        tensors, with use_kernel=False, or for a call autograd records.
        A `model.evidence` span; the plain encoder's own is a
        `model.encode` inside it."""
        with span("model.evidence"):
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
        ops.fused_decode.fused_viterbi_states.  A `score.viterbi_decode`
        span, its children `model.evidence` and `hmm.viterbi`."""
        with span("score.viterbi_decode"):
            log_pi, log_A, log_obs = self._evidence_inputs(x, u, lengths,
                                                           use_kernel)
            return viterbi_fused(log_pi, log_A, log_obs, lengths,
                                 use_kernel=use_kernel).states


def make_model(input_dim=5, hidden_dim=64, K=3, hidden_dim2=32, u_dim=4,
               trans_hidden=128, device=None, generator=None, **kw) -> VAEHMM:
    """The reference constructor's positional order, VAE_HMM(input_dim,
    hidden_dim, K, hidden_dim2, u_dim, trans_hidden), as a VAEHMM
    (vqvaehmm_tpu/models/vae_hmm.py::make_model); other ModelConfig fields
    by keyword, and the module's device and generator."""
    return VAEHMM(ModelConfig(input_dim=input_dim, hidden_dim=hidden_dim,
                              K=K, hidden_dim2=hidden_dim2, u_dim=u_dim,
                              trans_hidden=trans_hidden, **kw),
                  device=device, generator=generator)
