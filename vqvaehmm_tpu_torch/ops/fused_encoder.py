"""Fused encoder: conv3+ReLU -> mask -> conv3+ReLU -> 1x1 regime logits.

Port of the TPU kernel vqvaehmm_tpu/ops/pallas_encoder.py::_encoder_kernel
to a hand-written CUDA kernel for Hopper (csrc/fused_encoder.cu, whose
header sets out its design and the bound it meets).  `fused_encode` is
the wrapper, `fused_encode_reference` its plain PyTorch version and
`encode_supported` its gate.  It serves the inference path (posterior
extraction for the backtester and bulk scoring); its outputs carry no
gradient.

Dispatch is that of ops/fused_infer.py: `use_kernel=None` takes the
kernel for a CUDA tensor and the plain version for a CPU tensor,
`use_kernel=True` on a CPU tensor raises, `use_kernel=False` computes
the plain version.  There is no fallback: on a CUDA tensor the kernel
launches or an exception is raised.  One such exception: with grad mode
on and x or the encoder's weights requiring grad the kernel refuses, so
that no caller trains through a detached tensor unawares.
`fused_encode.launches` counts the kernel's launches.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from . import _build
from .fused_infer import SMEM_LIMIT, valid_to_rows

# csrc/encoder_tile.cuh: WS = TILE + 2 * ENC_HALO + ENC_JB floats a row of
# the encoder and evidence kernels' tile
TILE_ROW_FLOATS = 40

_count_lock = threading.Lock()


def smem_bytes(cfg) -> int:
    """Shared memory a block of the encoder kernel uses (the count of
    csrc/fused_encoder.cu::vqhmm_fused_encode_smem_bytes)."""
    return 4 * TILE_ROW_FLOATS * (cfg.input_dim + cfg.hidden_dim
                              + cfg.hidden_dim2 + cfg.K)


def encode_supported(cfg, B: int, T: int) -> bool:
    """True when the encoder kernel takes this model on Hopper: float32
    compute and one block's rows within a block's shared memory.  The
    kernel tiles along T, so B and T set no bound beyond the grid's."""
    return (cfg.compute_dtype == "float32" and B >= 0 and T >= 0
            and smem_bytes(cfg) <= SMEM_LIMIT)


def fused_encode_reference(model, x: torch.Tensor,
                           valid_to=None) -> torch.Tensor:
    """Plain version: the model's own convolution stack, (B, K, T)."""
    return model.encode(x, valid_to=valid_to, fused=False)


def encoder_weights(model, device: torch.device):
    """The encoder's six arrays, checked for the kernels that read them."""
    enc = model.encoder
    weights = [w.detach() for w in (
        enc.conv1.weight, enc.conv1.bias, enc.conv2.weight, enc.conv2.bias,
        enc.to_logits.weight, enc.to_logits.bias)]
    for w in weights:
        if w.device != device or w.dtype != torch.float32 \
                or not w.is_contiguous():
            raise ValueError("model weights must be contiguous float32 on "
                             f"{device} (got {w.dtype} on {w.device})")
    return weights


def refuse_grad(what: str, x: torch.Tensor, params) -> None:
    """Raise where autograd would expect a gradient through a kernel that
    carries none: grad mode on, and x or one of `params` requiring grad."""
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in params)):
        raise RuntimeError(
            f"the {what} kernel is inference-only and its outputs carry no "
            "gradient, but grad mode is on and x or the model's weights "
            "require grad: call it under torch.no_grad() or "
            "torch.inference_mode(), or take the differentiable plain "
            "version with fused=False / use_kernel=False")


def check_x(model, x: torch.Tensor, what: str) -> None:
    cfg = model.cfg
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 x, got {x.dtype}")
    if x.dim() != 3 or x.shape[1] != cfg.input_dim:
        raise ValueError(f"x must be (B, C={cfg.input_dim}, T), got "
                         f"{tuple(x.shape)}")


def fused_encode(model, x: torch.Tensor, valid_to=None,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """x (B, C, T) -> regime logits (B, K, T), with valid_to None, a scalar
    or a per-sequence (B,) vector (the semantics of VAEHMM.encode).  Row i
    of a batched call is bit-equal to the row computed alone."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return fused_encode_reference(model, x, valid_to)
    if not x.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor; the fused "
                         "encoder is a CUDA kernel")
    cfg = model.cfg
    refuse_grad("fused encoder", x, model.encoder.parameters())
    check_x(model, x, "fused encoder")
    B, C, T = x.shape
    if not encode_supported(cfg, B, T):
        raise ValueError(
            f"fused encoder unsupported for {cfg}: it computes in float32 "
            f"and needs {smem_bytes(cfg)} bytes of shared memory a block, "
            f"of at most {SMEM_LIMIT} (see encode_supported)")
    H1, H2, K = cfg.hidden_dim, cfg.hidden_dim2, cfg.K
    lib = _build.library()
    if lib.vqhmm_fused_encode_smem_bytes(C, H1, H2, K) != smem_bytes(cfg):
        raise RuntimeError("fused_encoder kernel and wrapper disagree on "
                           "the shared-memory layout")
    weights = encoder_weights(model, x.device)
    x = x.contiguous()
    vt = valid_to_rows(valid_to, B, T, x.device)
    logits = torch.empty((B, K, T), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return logits
    err = lib.vqhmm_fused_encode(
        x.data_ptr(), vt.data_ptr(), *[w.data_ptr() for w in weights],
        logits.data_ptr(), B, C, T, H1, H2, K,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_encoder kernel launch")
    with _count_lock:
        fused_encode.launches += 1
    return logits


fused_encode.launches = 0
