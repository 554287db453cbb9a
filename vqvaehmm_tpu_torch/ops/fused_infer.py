"""Fused serving forward: encoder -> softmax q -> soft codebook -> decoder.

Port of the TPU kernel vqvaehmm_tpu/ops/pallas_infer.py::_kernel to a
hand-written CUDA kernel for Hopper (csrc/fused_infer.cu, whose header
sets out its design and the bound it meets).  `fused_forward` is the
wrapper; `fused_forward_reference` is its plain PyTorch version;
`launch_plan` chooses the kernel's tile width from the work.

Dispatch (the counterpart of the JAX `use_pallas`; `kernel_route`):
`use_kernel=None` takes the kernel for a CUDA tensor of a float32 model
and the plain version for a CPU tensor or a bfloat16 model;
`use_kernel=True` on a CPU tensor or a bfloat16 model raises;
`use_kernel=False` computes the plain version.  There is no fallback: a
call that takes the kernel launches it or raises.

`fused_forward.launches` counts the kernel's launches, so a run can show
that its main path went through the kernel.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build

# Shared memory a Hopper block may use: 227 KB (NVIDIA H100 data sheet),
# requested as dynamic shared memory with cudaFuncSetAttribute.
SMEM_LIMIT = 232448
# SMs of an H100 SXM, for plans made without a card
H100_SMS = 132
# the tile widths the kernel takes, its halo, the steps a thread computes
# and the floats of one weight buffer (csrc/fused_infer.cu, tile_fma.cuh)
TILES = (64, 32, 16)
HALO = 4
JB = 4
WBUF = 6144
ROW_PAD = 8

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


class LaunchPlan(NamedTuple):
    tile: int          # output steps a block
    blocks: int        # B * ceil(T / tile)
    smem: int          # dynamic shared memory a block, bytes


def smem_bytes(tile: int, C: int, H1: int, H2: int, K: int, D: int) -> int:
    """Dynamic shared memory of a block at tile width `tile` (the same
    count as csrc/fused_infer.cu::vqhmm_fused_infer_smem_bytes): two weight
    buffers, a pad, then C + 2 max(H1, H2, D, 2C) + K rows of the window
    (the last layer leaves its 2C rows of mu and logvar in a buffer)."""
    return 4 * (2 * WBUF + ROW_PAD + (tile + 2 * HALO + JB)
                * (C + 2 * max(H1, H2, D, 2 * C) + K))


def _packed(O: int, I: int, taps: int) -> int:
    """Floats of one layer in the order the kernels stage it in
    (csrc/tile_fma.cuh): I * taps rows of O rounded up to 4."""
    return I * taps * ((O + 3) // 4 * 4)


def packed_floats(C: int, H1: int, H2: int, K: int, D: int) -> int:
    """Floats of the packed weights a call allocates (the same count as
    csrc/fused_infer.cu::packed)."""
    return (_packed(H1, C, 3) + _packed(H2, H1, 3) + _packed(K, H2, 1)
            + _packed(D, K, 1) + 2 * _packed(D, D, 3) + _packed(2 * C, D, 1))


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, T: int, C: int, H1: int, H2: int, K: int, D: int,
                sms: int = H100_SMS) -> LaunchPlan:
    """The widest tile for which the grid still has a block for every SM
    and a block's shared memory fits; where B * T is too small for that,
    the narrowest tile that fits (the most blocks).  Raises where no tile
    fits or a layer is too wide for a weight buffer."""
    if 3 * ((max(H1, H2, D) + 3) // 4 * 4) > WBUF \
            or (max(K, 2 * C) + 3) // 4 * 4 > WBUF:
        raise ValueError(f"fused forward takes hidden widths up to "
                         f"{WBUF // 3} and K, 2 * input_dim up to {WBUF}, "
                         f"got hidden={H1}/{H2}, K={K}, input_dim={C}")
    fits = [LaunchPlan(t, B * -(-T // t), smem_bytes(t, C, H1, H2, K, D))
            for t in TILES]
    fits = [p for p in fits if p.smem <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"fused forward needs {smem_bytes(TILES[-1], C, H1, H2, K, D)} "
            f"bytes of shared memory per block at C={C}, hidden={H1}/{H2}, "
            f"K={K}; a Hopper block may use at most {SMEM_LIMIT} bytes")
    for p in fits:
        if p.blocks >= sms:
            return p
    return fits[-1]


def kernel_route(model, x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """Whether a call of one of the float32 inference kernels (A, 8, 10,
    11) launches it: use_kernel as given, and for None the kernel for a
    CUDA tensor of a float32 model.  A bfloat16 model takes its plain
    path on every device, as the JAX package routes such a model around
    these kernels (vqvaehmm_tpu/models/vae_hmm.py, posterior and
    infer_forward)."""
    if use_kernel is None:
        return x.is_cuda and model.cfg.compute_dtype == "float32"
    return use_kernel


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
    if not kernel_route(model, x, use_kernel):
        return fused_forward_reference(model, x, valid_to)
    cfg = model.cfg
    if cfg.compute_dtype != "float32":
        raise ValueError(f"the fused forward computes in float32; a "
                         f"{cfg.compute_dtype} model takes the plain path "
                         "(use_kernel=None or False)")
    if not x.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor; the fused "
                         "forward is a CUDA kernel")
    if x.dtype != torch.float32:
        raise TypeError(f"fused forward takes float32 x, got {x.dtype}")
    if x.dim() != 3 or x.shape[1] != cfg.input_dim:
        raise ValueError(f"x must be (B, C={cfg.input_dim}, T), got "
                         f"{tuple(x.shape)}")
    B, C, T = x.shape
    mu = torch.empty((B, C, T), dtype=torch.float32, device=x.device)
    logvar = torch.empty_like(mu)
    q = torch.empty((B, cfg.K, T), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return mu, logvar, q
    plan = launch_plan(B, T, C, cfg.hidden_dim, cfg.hidden_dim2, cfg.K,
                       cfg.hidden_dim, _build.sm_count(x.device))
    _launch(model, x, valid_to, plan.tile, (mu, logvar, q))
    with _count_lock:
        fused_forward.launches += 1
    return mu, logvar, q


def _launch(model, x, valid_to, tile: int, out) -> None:
    """One launch of the kernel at tile width `tile` into out = (mu,
    logvar, q).  It does not count: fused_forward does."""
    cfg = model.cfg
    B, C, T = x.shape
    H1, H2, K, D = cfg.hidden_dim, cfg.hidden_dim2, cfg.K, cfg.hidden_dim
    lib = _build.library()
    n_packed = _checked_sizes(lib, C, H1, H2, K, D, tile)
    weights = [w.detach() for w in _weights(model)]
    for w in weights:
        if w.device != x.device or w.dtype != torch.float32 \
                or not w.is_contiguous():
            raise ValueError("model weights must be contiguous float32 on "
                             f"{x.device} (got {w.dtype} on {w.device})")
    x = x.contiguous()
    vt = valid_to_rows(valid_to, B, T, x.device)
    packed = torch.empty(n_packed, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.vqhmm_fused_infer(
        x.data_ptr(), vt.data_ptr(), *[w.data_ptr() for w in weights],
        packed.data_ptr(), *[o.data_ptr() for o in out], B, C, T, H1, H2, K, D, tile, stream)
    _build.check(err, "fused_infer kernel launch")


_sizes: dict = {}


def _checked_sizes(lib, C, H1, H2, K, D, tile) -> int:
    """Floats of the packed weights, after the wrapper's shared-memory and
    packed sizes were held once against the built library's."""
    key = (C, H1, H2, K, D, tile)
    if key not in _sizes:
        smem = lib.vqhmm_fused_infer_smem_bytes(C, H1, H2, K, D, tile)
        n_packed = lib.vqhmm_fused_infer_packed_floats(C, H1, H2, K, D)
        if smem != smem_bytes(tile, C, H1, H2, K, D) or smem > SMEM_LIMIT \
                or n_packed != packed_floats(C, H1, H2, K, D):
            raise RuntimeError(
                f"fused_infer kernel and wrapper disagree at tile {tile}: "
                f"{smem} bytes of shared memory, {n_packed} packed floats")
        _sizes[key] = n_packed
    return _sizes[key]


fused_forward.launches = 0
