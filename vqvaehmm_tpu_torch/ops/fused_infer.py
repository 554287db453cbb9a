"""Fused serving forward: encoder -> softmax q -> soft codebook -> decoder.

Port of the TPU kernel vqvaehmm_tpu/ops/pallas_infer.py::_kernel to a
hand-written CUDA kernel for Hopper (csrc/fused_infer.cu, whose header
sets out its design and the bound it meets).  `fused_forward` is the
wrapper; `fused_forward_reference` is its plain PyTorch version.

Dispatch (the counterpart of the JAX `use_pallas`): `use_kernel=None`
takes the kernel for a CUDA tensor and the plain version for a CPU
tensor; `use_kernel=True` on a CPU tensor raises; `use_kernel=False`
computes the plain version.  There is no fallback: on a CUDA tensor the
kernel launches or an exception is raised.

`fused_forward.launches` counts the kernel's launches, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from . import _build

# Shared memory a Hopper block may use: 227 KB (NVIDIA H100 data sheet).
SMEM_LIMIT = 232448

_count_lock = threading.Lock()


def valid_to_rows(valid_to, B: int, T: int,
                  device: torch.device) -> torch.Tensor:
    """valid_to as a (B,) int32 tensor: None bounds every row at T, a
    scalar bounds every row at that value, a (B,) vector bounds each row
    at its own value."""
    if valid_to is None:
        return torch.full((B,), T, dtype=torch.int32, device=device)
    vt = torch.as_tensor(valid_to, device=device).to(torch.int32)
    if vt.dim() == 0:
        return vt.expand(B).contiguous()
    if tuple(vt.shape) != (B,):
        raise ValueError(f"valid_to must be a scalar or ({B},), got "
                         f"{tuple(vt.shape)}")
    return vt.contiguous()


def fused_forward_reference(model, x: torch.Tensor, valid_to=None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version: (mu, logvar, q), each (B, C|K, T)."""
    logits = model.encode(x, valid_to=valid_to, fused=False)
    q = torch.softmax(logits, dim=1)
    mu, logvar = model.decode(q, valid_to=valid_to)
    return mu, logvar, q


def _weights(model):
    enc, dec = model.encoder, model.decoder
    return (enc.conv1.weight, enc.conv1.bias, enc.conv2.weight,
            enc.conv2.bias, enc.to_logits.weight, enc.to_logits.bias,
            dec.embeddings.weight, dec.conv1.weight, dec.conv1.bias,
            dec.conv2.weight, dec.conv2.bias, dec.to_params.weight,
            dec.to_params.bias)


def fused_forward(model, x: torch.Tensor, valid_to=None,
                  use_kernel: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mu, logvar, q), each (B, C|K, T), with valid_to a scalar or a
    per-sequence (B,) vector (the semantics of VAEHMM.encode/decode).
    The kernel is inference-only, as its TPU counterpart is: its outputs
    carry no gradient (use_kernel=False gives the differentiable plain
    version)."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return fused_forward_reference(model, x, valid_to)
    if not x.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor; the fused "
                         "forward is a CUDA kernel")
    cfg = model.cfg
    if x.dtype != torch.float32:
        raise TypeError(f"fused forward takes float32 x, got {x.dtype}")
    if x.dim() != 3 or x.shape[1] != cfg.input_dim:
        raise ValueError(f"x must be (B, C={cfg.input_dim}, T), got "
                         f"{tuple(x.shape)}")
    B, C, T = x.shape
    H1, H2, K, D = cfg.hidden_dim, cfg.hidden_dim2, cfg.K, cfg.hidden_dim
    lib = _build.library()
    smem = lib.vqhmm_fused_infer_smem_bytes(C, H1, H2, K, D)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"fused forward needs {smem} bytes of shared memory per block "
            f"at C={C}, hidden={H1}/{H2}, K={K}; a Hopper block may use "
            f"at most {SMEM_LIMIT} bytes")
    weights = [w.detach() for w in _weights(model)]
    for w in weights:
        if w.device != x.device or w.dtype != torch.float32 \
                or not w.is_contiguous():
            raise ValueError("model weights must be contiguous float32 on "
                             f"{x.device} (got {w.dtype} on {w.device})")
    x = x.contiguous()
    vt = valid_to_rows(valid_to, B, T, x.device)
    mu = torch.empty((B, C, T), dtype=torch.float32, device=x.device)
    logvar = torch.empty_like(mu)
    q = torch.empty((B, K, T), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return mu, logvar, q
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.vqhmm_fused_infer(
        x.data_ptr(), vt.data_ptr(), *[w.data_ptr() for w in weights],
        mu.data_ptr(), logvar.data_ptr(), q.data_ptr(),
        B, C, T, H1, H2, K, D, stream)
    _build.check(err, "fused_infer kernel launch")
    with _count_lock:
        fused_forward.launches += 1
    return mu, logvar, q


fused_forward.launches = 0
