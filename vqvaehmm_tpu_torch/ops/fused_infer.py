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

Two modes of arithmetic, as the TPU kernel's `highest` flag has
(ops/fused_train.py::infer_bf16_mode): float32, and on a CUDA tensor of a
float32 model whose matmul_precision is not "highest" the
bfloat16-operand mode (both operands of every product rounded to
bfloat16, float32 sums, on the tensor cores), whose plain version is
`fused_forward_reference(bf16_operands=True)`; `use_kernel=False` takes
that plain version on the card.  Each mode has its own launch plan and
shared-memory count; a shape the mode's plan refuses raises.  The packed
weights are kept a model, weight version and mode
(ops/fused_encoder.py::KernelCache).

`fused_forward.launches` counts the kernel's launches in either mode,
`fused_forward.bf16_launches` those in the bfloat16-operand mode, so a
run can show that its main path went through the kernel.
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


def _op_stride(n: int) -> int:
    """bfloat16 values a row of an operand of n channels
    (csrc/tile_mma.cuh::op_stride)."""
    return -(-n // 16) * 16 + 8


def smem_bytes(tile: int, C: int, H1: int, H2: int, K: int, D: int,
               bf16: bool = False) -> int:
    """Dynamic shared memory of a block at tile width `tile` (the same
    count as csrc/fused_infer.cu::vqhmm_fused_infer_smem_bytes): two weight
    buffers, a pad, then C + 2 max(H1, H2, D, 2C) + K rows of the window
    (the last layer leaves its 2C rows of mu and logvar in a buffer).
    bf16 (the same entry at bf16 = 1): bfloat16 operands of
    tile + 2 HALO rows, x and two ping-pong buffers of the widest of H1,
    H2, D and K, then K + 2C float32 rows of the window."""
    if bf16:
        return (2 * (tile + 2 * HALO) * (_op_stride(C) + 2 * _op_stride(
            max(H1, H2, D, K))) + 4 * (tile + 2 * HALO + JB) * (K + 2 * C))
    return 4 * (2 * WBUF + ROW_PAD + (tile + 2 * HALO + JB)
                * (C + 2 * max(H1, H2, D, 2 * C) + K))


def _packed(O: int, I: int, taps: int) -> int:
    """Floats of one layer in the order the kernels stage it in
    (csrc/tile_fma.cuh): I * taps rows of O rounded up to 4."""
    return I * taps * ((O + 3) // 4 * 4)


def packed_floats(C: int, H1: int, H2: int, K: int, D: int) -> int:
    """Floats of the packed weights (the same count as
    csrc/fused_infer.cu::packed)."""
    return (_packed(H1, C, 3) + _packed(H2, H1, 3) + _packed(K, H2, 1)
            + _packed(D, K, 1) + 2 * _packed(D, D, 3) + _packed(2 * C, D, 1))


def layers(C: int, H1: int, H2: int, K: int, D: int):
    """(O, I, taps, transposed) of the seven packed layers in order: the
    encoder's three, the codebook as the transposed layer e = E^T q, the
    decoder's three."""
    return ((H1, C, 3, False), (H2, H1, 3, False), (K, H2, 1, False),
            (D, K, 1, True), (D, D, 3, False), (D, D, 3, False),
            (2 * C, D, 1, False))


def packed_bf16(C: int, H1: int, H2: int, K: int, D: int) -> int:
    """bfloat16 values of the bfloat16 mode's packed weights
    (csrc/fused_infer.cu::packed_bf16): each layer round16(O) x taps x
    round16(I), in mma fragment order (csrc/tile_mma.cuh)."""
    return sum(-(-O // 16) * 16 * taps * -(-I // 16) * 16
               for O, I, taps, _ in layers(C, H1, H2, K, D))


@functools.lru_cache(maxsize=None)
def launch_plan(B: int, T: int, C: int, H1: int, H2: int, K: int, D: int,
                sms: int = H100_SMS, bf16: bool = False) -> LaunchPlan:
    """The widest tile for which the grid still has a block for every SM
    and a block's shared memory (in the mode: `smem_bytes`) fits; where
    B * T is too small for that, the narrowest tile that fits (the most
    blocks).  Raises where no tile fits or, in the float32 mode, a layer
    is too wide for a weight buffer (the bfloat16 mode stages no
    weights)."""
    if not bf16 and (3 * ((max(H1, H2, D) + 3) // 4 * 4) > WBUF
                     or (max(K, 2 * C) + 3) // 4 * 4 > WBUF):
        raise ValueError(f"fused forward takes hidden widths up to "
                         f"{WBUF // 3} and K, 2 * input_dim up to {WBUF}, "
                         f"got hidden={H1}/{H2}, K={K}, input_dim={C}")
    fits = [LaunchPlan(t, B * -(-T // t),
                       smem_bytes(t, C, H1, H2, K, D, bf16)) for t in TILES]
    fits = [p for p in fits if p.smem <= SMEM_LIMIT]
    if not fits:
        mode = "its bfloat16-operand mode" if bf16 else "float32"
        raise ValueError(
            f"fused forward in {mode} needs "
            f"{smem_bytes(TILES[-1], C, H1, H2, K, D, bf16)} "
            f"bytes of shared memory per block at C={C}, hidden={H1}/{H2}, "
            f"K={K}; a Hopper block may use at most {SMEM_LIMIT} bytes")
    for p in fits:
        if p.blocks >= sms:
            return p
    return fits[-1]


def kernel_route(model, x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """Whether a call of one of the inference kernels (A, 8, 10, 11)
    launches it: use_kernel as given, and for None the kernel for a CUDA
    tensor of a float32 model.  A bfloat16 model takes its plain path on
    every device, as the JAX package routes such a model around these
    kernels (vqvaehmm_tpu/models/vae_hmm.py, posterior and
    infer_forward)."""
    if use_kernel is None:
        return x.is_cuda and model.cfg.compute_dtype == "float32"
    return use_kernel


def operand_mode(model, x: torch.Tensor) -> bool:
    """The mode of kernels A, 8, 10 and 11 and of their wrappers' plain
    route for x: ops/fused_train.py::infer_bf16_mode on x's device."""
    # fused_train imports this module's constants
    from .fused_train import infer_bf16_mode

    return infer_bf16_mode(model.cfg, x.device)


def fused_forward_reference(model, x: torch.Tensor, valid_to=None,
                            bf16_operands: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain version: (mu, logvar, q), each (B, C|K, T).  bf16_operands:
    the bfloat16-operand mode's (VAEHMM.encode/decode(bf16_operands=True))."""
    logits = model.encode(x, valid_to=valid_to, fused=False,
                          bf16_operands=bf16_operands)
    q = torch.softmax(logits, dim=1)
    mu, logvar = model.decode(q, valid_to=valid_to,
                              bf16_operands=bf16_operands)
    return mu, logvar, q


def fused_forward(model, x: torch.Tensor, valid_to=None,
                  use_kernel: Optional[bool] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mu, logvar, q), each (B, C|K, T), with valid_to a scalar or a
    per-sequence (B,) vector (the semantics of VAEHMM.encode/decode).
    The kernel is inference-only, as its TPU counterpart is: its outputs
    carry no gradient (use_kernel=False gives the differentiable plain
    version)."""
    bf16 = operand_mode(model, x)
    if not kernel_route(model, x, use_kernel):
        return fused_forward_reference(model, x, valid_to, bf16)
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
                       cfg.hidden_dim, _build.sm_count(x.device), bf16)
    _launch(model, x, valid_to, plan.tile, (mu, logvar, q), bf16)
    with _count_lock:
        fused_forward.launches += 1
        fused_forward.bf16_launches += bf16
    return mu, logvar, q


def _launch(model, x, valid_to, tile: int, out, bf16: bool = False) -> None:
    """One launch of the kernel at tile width `tile`, in the
    bfloat16-operand mode where bf16, into out = (mu, logvar, q).  It does
    not count: fused_forward does."""
    from .fused_encoder import kernel_cache   # it imports this module

    cfg = model.cfg
    B, C, T = x.shape
    H1, H2, K, D = cfg.hidden_dim, cfg.hidden_dim2, cfg.K, cfg.hidden_dim
    lib = _build.library()
    _check_smem(lib, C, H1, H2, K, D, tile, bf16)
    packed, bs = kernel_cache(model).weights(model, x.device, "infer", bf16)
    x = x.contiguous()
    vt = valid_to_rows(valid_to, B, T, x.device)
    err = lib.vqhmm_fused_infer(
        x.data_ptr(), vt.data_ptr(), packed.data_ptr(),
        *[b.data_ptr() for b in bs], *[o.data_ptr() for o in out], B, C, T,
        H1, H2, K, D, tile, int(bf16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_infer kernel launch")


_smem_checked: set = set()


def _check_smem(lib, C, H1, H2, K, D, tile, bf16) -> None:
    """Hold the wrapper's shared-memory count once against the built
    library's, a shape and mode."""
    key = (C, H1, H2, K, D, tile, bf16)
    if key not in _smem_checked:
        smem = lib.vqhmm_fused_infer_smem_bytes(C, H1, H2, K, D, tile,
                                                int(bf16))
        if smem != smem_bytes(tile, C, H1, H2, K, D, bf16) \
                or smem > SMEM_LIMIT:
            raise RuntimeError(
                f"fused_infer kernel and wrapper disagree at tile {tile} "
                f"(bf16={bf16}): {smem} bytes of shared memory")
        _smem_checked.add(key)


fused_forward.launches = 0
fused_forward.bf16_launches = 0
