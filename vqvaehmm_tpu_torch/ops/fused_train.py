"""Fused training step: the masked negative ELBO and all 18 parameter
gradients in one kernel call.

Port of the TPU kernel vqvaehmm_tpu/ops/pallas_train.py::_kernel (and the
loss assembly and log_prior chain of its wrapper) to a hand-written CUDA
kernel for Hopper, csrc/fused_train.cu, whose header sets out its design
and the bound it meets.

* `fused_loss_and_grads(model, x, u, lengths, beta)` -> (loss, grads):
  the counterpart of jax.value_and_grad(model.compute_loss), with `grads`
  a dict keyed like `model.state_dict()`.  On CUDA tensors it is one call
  of the kernel; on CPU tensors it is the plain version
  (`fused_loss_and_grads_reference`: compute_loss plus
  torch.autograd.grad).  `use_kernel=True` on a CPU tensor raises.
* `FusedELBO`, a torch.autograd.Function: its forward runs the kernel and
  keeps the gradients, its backward hands them out scaled by the
  incoming gradient, so `loss.backward()` fills every parameter's `.grad`
  without a second kernel.  Like the TPU kernel it gives no gradient for
  x or u.
* `train_step_supported(cfg, B, T)`: the gate the trainer consults before
  it chooses the kernel.

`fused_loss_and_grads.launches` counts the kernel's calls (each call is
one launch of the per-sequence kernel and one of its fixed-order
reduction).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

from . import _build

# the kernel keeps K regimes a thread in registers (csrc/fused_train.cu)
KMAX = 16
_INT32_MAX = 2 ** 31 - 1

_count_lock = threading.Lock()

# the 18 parameter arrays in state_dict order, the kernel's argument order
PARAM_NAMES = (
    "encoder.conv1.weight", "encoder.conv1.bias",
    "encoder.conv2.weight", "encoder.conv2.bias",
    "encoder.to_logits.weight", "encoder.to_logits.bias",
    "prior.log_prior",
    "prior.transition_net.0.weight", "prior.transition_net.0.bias",
    "prior.transition_net.2.weight", "prior.transition_net.2.bias",
    "decoder.embeddings.weight",
    "decoder.conv1.weight", "decoder.conv1.bias",
    "decoder.conv2.weight", "decoder.conv2.bias",
    "decoder.to_params.weight", "decoder.to_params.bias",
)


def scratch_rows(cfg) -> int:
    """Rows of T floats of one sequence's activation scratch (the same
    count as csrc/fused_train.cu::scratch_rows)."""
    D, H1, H2, HP, K, C = (cfg.hidden_dim, cfg.hidden_dim, cfg.hidden_dim2,
                           cfg.trans_hidden, cfg.K, cfg.input_dim)
    G = max(D, H1, H2, HP)
    return H1 + H2 + 3 * K + HP + 2 * K * K + 3 * D + 2 * C + 2 * G


def train_step_supported(cfg, B: int, T: int) -> bool:
    """True when the fused train kernel takes these shapes on Hopper:
    float32 compute, u-conditioned transitions, at most KMAX regimes (a
    thread keeps K values in registers), and one sequence's scratch and
    the per-block indexing within 32-bit offsets.  The kernel uses about
    12 KB of static shared memory a block at any shape, so shared memory
    sets no bound."""
    return (cfg.compute_dtype == "float32" and cfg.u_dim is not None
            and B > 0 and T > 0 and 1 <= cfg.K <= KMAX
            and scratch_rows(cfg) * T <= _INT32_MAX
            and max(cfg.hidden_dim, cfg.trans_hidden) * T <= _INT32_MAX)


def _u_strides(cfg, u: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, channel, time) strides of u, read as (B, U, T) when its
    dim 1 equals u_dim and as (B, T, U) otherwise (VAEHMM.prior's rule)."""
    sb, s1, s2 = u.stride()
    if u.shape[1] == cfg.u_dim:
        return sb, s1, s2
    return sb, s2, s1


def fused_loss_and_grads_reference(model, x: torch.Tensor, u: torch.Tensor,
                                   lengths: torch.Tensor, beta
                                   ) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
    """Plain version: model.compute_loss and torch.autograd.grad."""
    names, params = zip(*model.named_parameters())
    with torch.enable_grad():
        loss = model.compute_loss(x, u, lengths, beta)
        grads = torch.autograd.grad(loss, params)
    return loss.detach(), dict(zip(names, grads))


def _check_inputs(model, x, u, lengths):
    cfg = model.cfg
    if x.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"fused train step takes float32 x and u, got "
                        f"{x.dtype} and {u.dtype}")
    if x.dim() != 3 or x.shape[1] != cfg.input_dim:
        raise ValueError(f"x must be (B, C={cfg.input_dim}, T), got "
                         f"{tuple(x.shape)}")
    B, C, T = x.shape
    if u.dim() != 3 or u.shape[0] != B or not (
            tuple(u.shape[1:]) == (cfg.u_dim, T)
            or tuple(u.shape[1:]) == (T, cfg.u_dim)):
        raise ValueError(f"u must be (B, U={cfg.u_dim}, T) or (B, T, U), "
                         f"got {tuple(u.shape)} for x {tuple(x.shape)}")
    if tuple(lengths.shape) != (B,):
        raise ValueError(f"lengths must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    for t in (x, u, lengths):
        if t.device != x.device:
            raise ValueError("x, u and lengths must be on one device")


def _kernel_call(lib, model, x, u, lengths, beta, stream
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the kernel through `lib`: (loss (), flat grads (P,))."""
    cfg = model.cfg
    params = dict(model.named_parameters())
    weights = [params[n].detach() for n in PARAM_NAMES]
    for n, w in zip(PARAM_NAMES, weights):
        if w.device != x.device or w.dtype != torch.float32 \
                or not w.is_contiguous():
            raise ValueError(f"parameter {n} must be contiguous float32 on "
                             f"{x.device} (got {w.dtype} on {w.device})")
    B, C, T = x.shape
    U, H1, H2, K, HP, D = (cfg.u_dim, cfg.hidden_dim, cfg.hidden_dim2,
                           cfg.K, cfg.trans_hidden, cfg.hidden_dim)
    dims = (B, C, T, U, H1, H2, K, HP, D)
    P = lib.vqhmm_fused_train_sizes(*dims, 0)
    rows = lib.vqhmm_fused_train_sizes(*dims, 1)
    if rows != scratch_rows(cfg) or P != sum(w.numel() for w in weights):
        raise RuntimeError("fused_train kernel and wrapper disagree on the "
                           "scratch or gradient layout")
    x = x.contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    dev = x.device
    scratch = torch.empty(B * rows * T, dtype=torch.float32, device=dev)
    partials = torch.empty(B * P, dtype=torch.float32, device=dev)
    loss_partials = torch.empty(B * 3, dtype=torch.float64, device=dev)
    grads = torch.empty(P, dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    err = lib.vqhmm_fused_train(
        x.data_ptr(), u.data_ptr(), *_u_strides(cfg, u), lengths.data_ptr(),
        *[w.data_ptr() for w in weights], scratch.data_ptr(),
        partials.data_ptr(), loss_partials.data_ptr(), grads.data_ptr(),
        loss.data_ptr(),
        *dims, float(beta), stream)
    _build.check(err, "fused_train kernel launch")
    return loss, grads


def split_grads(model, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The kernel's flat gradient vector as views shaped like the
    parameters, keyed like state_dict()."""
    params = dict(model.named_parameters())
    out, at = {}, 0
    for n in PARAM_NAMES:
        p = params[n]
        out[n] = flat[at:at + p.numel()].view(p.shape)
        at += p.numel()
    return out


def fused_loss_and_grads(model, x: torch.Tensor, u: torch.Tensor,
                         lengths: torch.Tensor, beta,
                         use_kernel: Optional[bool] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, grads) of model.compute_loss(x, u, lengths, beta), grads
    keyed like state_dict().  The caller checks train_step_supported
    first; an unsupported shape raises here."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return fused_loss_and_grads_reference(model, x, u, lengths, beta)
    if not x.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the fused "
                         "train step is a CUDA kernel")
    _check_inputs(model, x, u, lengths)
    B, _, T = x.shape
    if not train_step_supported(model.cfg, B, T):
        raise ValueError(f"fused train step unsupported at B={B}, T={T} "
                         f"for {model.cfg} (see train_step_supported)")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    loss, flat = _kernel_call(_build.library(), model, x, u, lengths, beta,
                              stream)
    with _count_lock:
        fused_loss_and_grads.launches += 1
    return loss, split_grads(model, flat)


fused_loss_and_grads.launches = 0


class FusedELBO(torch.autograd.Function):
    """loss = FusedELBO.apply(model, x, u, lengths, beta, *params), with
    params = tuple(p for _, p in model.named_parameters()).  The forward
    computes the loss and every parameter gradient in the kernel (or the
    plain version on the CPU); the backward returns
    grad_output * gradient for the parameters and None for the rest."""

    @staticmethod
    def forward(ctx, model, x, u, lengths, beta, *params):
        loss, grads = fused_loss_and_grads(model, x, u, lengths, beta)
        ctx.save_for_backward(*[grads[n] for n, _ in
                                model.named_parameters()])
        return loss

    @staticmethod
    def backward(ctx, grad_output):
        return (None, None, None, None, None,
                *[grad_output * g for g in ctx.saved_tensors])
