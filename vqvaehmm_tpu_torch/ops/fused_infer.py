"""Fused serving forward: encoder -> softmax q -> soft codebook -> decoder.

Port of the TPU kernel vqvaehmm_tpu/ops/pallas_infer.py::_kernel to a
hand-written CUDA kernel for Hopper (csrc/fused_infer.cu, whose header
sets out its design and the bound it meets).  `fused_forward` is the
wrapper; `fused_forward_reference` is its plain PyTorch version;
`launch_plan` chooses the kernel's tile width from the work.

Dispatch (the counterpart of the JAX `use_pallas`; `kernel_route`):
`use_kernel=None` takes the kernel for a CUDA tensor of a float32 model
and the plain version for a CPU tensor or a bfloat16 model, and for a
call that autograd would record (grad mode on and x or a weight of the
stage requiring grad), as JAX's auto-dispatch steps aside for a
differentiating caller; `use_kernel=True` on a CPU tensor or a bfloat16
model raises, and so does it under autograd (`refuse_grad`: the kernel
carries no gradient); `use_kernel=False` computes the plain version.
There is no fallback: a call that takes the kernel launches it or
raises.

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
# an SM's shared memory (228 KB), and the bfloat16 mode's blocks an SM at
# most (csrc/fused_infer.cu: __launch_bounds__(256, 2))
SM_SMEM = 228 * 1024
MMA_BLOCKS_PER_SM = 2
# the staged weights of the bfloat16 mode (csrc/tile_mma.cuh::stage_plan):
# a ring's slots at most, a slot's bfloat16 values, the control region's
# bytes (the barriers, the ring's copy of the chain)
RING_SLOTS = 8
SLOT_ELEMS = 8 * 256
CTRL_BYTES = 8 * 2 * RING_SLOTS + 32 * 8

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
    blocks: int        # items: B * ceil(T / tile)
    smem: int          # dynamic shared memory a block, bytes
    grid: int = 0      # blocks launched (the bfloat16 mode: a persistent
    #                    grid walks the items where its weights are
    #                    resident); 0 in float32, a block an item
    weights: str = ""  # the bfloat16 mode's weights: WEIGHT_KINDS


def _op_stride(n: int) -> int:
    """bfloat16 values a row of an operand of n channels
    (csrc/tile_mma.cuh::op_stride)."""
    return -(-n // 16) * 16 + 8


# csrc/tile_mma.cuh::WeightKind, by value
WEIGHT_KINDS = ("direct", "resident", "ring")


class StagePlan(NamedTuple):
    weights: str       # "resident", "ring" or "direct"
    slots: int         # the ring's
    bytes: int         # the block's dynamic shared memory


def stage_plan(base: int, prefetch: int, elems: int) -> StagePlan:
    """Where a bfloat16-mode block of kernel A or 11 keeps its weights,
    after `base` bytes of operands (csrc/tile_mma.cuh::stage_plan):
    resident with `prefetch` bytes of raw input, the control region and
    all `elems` packed values where they fit; else the control region and
    a ring of as many slots as fit, up to RING_SLOTS, where two do; else
    read from L2 (direct), the operands alone."""
    resident = base + prefetch + CTRL_BYTES + 2 * elems
    if resident <= SMEM_LIMIT:
        return StagePlan("resident", 0, resident)
    slots = min(RING_SLOTS, (SMEM_LIMIT - base - CTRL_BYTES)
                // (2 * SLOT_ELEMS))
    if slots >= 2:
        return StagePlan("ring", slots, base + CTRL_BYTES
                         + slots * 2 * SLOT_ELEMS)
    return StagePlan("direct", 0, base)


def operand_bytes(tile: int, C: int, H1: int, H2: int, K: int,
                  D: int) -> int:
    """The bfloat16 mode's operands (csrc/fused_infer.cu::
    bf16_operand_bytes): bfloat16 operands of tile + 2 HALO rows, x and
    two ping-pong buffers of the widest of H1, H2, D and K, then K + 2C
    float32 rows of the window."""
    return (2 * (tile + 2 * HALO) * (_op_stride(C) + 2 * _op_stride(
        max(H1, H2, D, K))) + 4 * (tile + 2 * HALO + JB) * (K + 2 * C))


def bf16_stage(tile: int, C: int, H1: int, H2: int, K: int,
               D: int) -> StagePlan:
    """The bfloat16 mode's weights at tile width `tile`
    (csrc/fused_infer.cu::bf16_stage): the operands, the next item's raw
    x window (C rows of tile + 2 HALO floats) where resident, the seven
    layers' packed values."""
    return stage_plan(operand_bytes(tile, C, H1, H2, K, D),
                      4 * C * (tile + 2 * HALO),
                      packed_bf16(C, H1, H2, K, D))


def smem_bytes(tile: int, C: int, H1: int, H2: int, K: int, D: int,
               bf16: bool = False) -> int:
    """Dynamic shared memory of a block at tile width `tile` (the same
    count as csrc/fused_infer.cu::vqhmm_fused_infer_smem_bytes): two weight
    buffers, a pad, then C + 2 max(H1, H2, D, 2C) + K rows of the window
    (the last layer leaves its 2C rows of mu and logvar in a buffer).
    bf16 (the same entry at bf16 = 1): the operands, then the weights
    where `bf16_stage` puts them."""
    if bf16:
        return bf16_stage(tile, C, H1, H2, K, D).bytes
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
    is too wide for a weight buffer (the bfloat16 mode stages its weights
    whole, in a ring or not at all).  In the bfloat16 mode a grid of the
    blocks that stay resident (MMA_BLOCKS_PER_SM an SM, as shared memory
    allows) walks the items where its weights are resident, so that each
    block stages them once; a block an item otherwise, and wherever the
    items are fewer."""
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
    plan = next((p for p in fits if p.blocks >= sms), fits[-1])
    if not bf16:
        return plan
    stage = bf16_stage(plan.tile, C, H1, H2, K, D)
    grid = plan.blocks
    if stage.weights == "resident":
        per_sm = min(MMA_BLOCKS_PER_SM, SM_SMEM // (plan.smem + 1024))
        grid = min(grid, per_sm * sms)
    return plan._replace(grid=grid, weights=stage.weights)


def on_card(x: torch.Tensor) -> bool:
    """Whether x lies where the inference kernels run (a CUDA tensor);
    the routing tests stand a fake in for it on the CPU."""
    return x.is_cuda


def under_autograd(*tensors) -> bool:
    """Whether autograd records a call on `tensors` (x, u and the weights
    of a kernel's stage; None, or anything else that is no tensor, is
    skipped): grad mode on and one of them requiring grad."""
    return torch.is_grad_enabled() and any(
        getattr(t, "requires_grad", False) for t in tensors)


def infer_tensors(model) -> list:
    """The weights kernel A reads: the encoder's and the decoder's."""
    return [*model.encoder.parameters(), *model.decoder.parameters()]


def kernel_route(model, x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """Whether a call of one of the inference kernels (A, 8, 10, 11)
    launches it by device and dtype: use_kernel as given, and for None the
    kernel for a CUDA tensor of a float32 model.  A bfloat16 model takes
    its plain path on every device, as the JAX package routes such a
    model around these kernels (vqvaehmm_tpu/models/vae_hmm.py, posterior
    and infer_forward).  The wrappers ask `autograd_aside` too."""
    if use_kernel is None:
        return on_card(x) and model.cfg.compute_dtype == "float32"
    return use_kernel


def autograd_aside(use_kernel: Optional[bool], x: torch.Tensor,
                   tensors) -> bool:
    """Whether a default call (use_kernel None) steps aside from its kernel
    because autograd would record it on x and `tensors` (the stage's
    weights, and u): the kernels carry no gradient, so a differentiating
    caller gets the differentiable plain version, in the mode's
    arithmetic, as the JAX package's auto-dispatch steps aside for an
    autodiff tracer (vqvaehmm_tpu/models/vae_hmm.py, posterior,
    infer_forward and viterbi_decode).  A forced kernel does not step
    aside: it raises (`refuse_grad`)."""
    return use_kernel is None and under_autograd(x, *tensors)


def refuse_grad(what: str, x: torch.Tensor, tensors) -> None:
    """Raise where a call forced onto a kernel (use_kernel=True) would
    hand autograd a tensor without a gradient: grad mode on, and x or one
    of `tensors` requiring grad."""
    if under_autograd(x, *tensors):
        raise RuntimeError(
            f"the {what} kernel is inference-only and its outputs carry no "
            "gradient, but grad mode is on and x, u or the model's weights "
            "require grad: call it under torch.no_grad() or "
            "torch.inference_mode(), or leave use_kernel / fused None (or "
            "pass fused=False / use_kernel=False) for the differentiable "
            "plain version")


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
    carry no gradient, so a call that autograd records takes the
    differentiable plain version (use_kernel=True then raises)."""
    bf16 = operand_mode(model, x)
    weights = infer_tensors(model)
    if not kernel_route(model, x, use_kernel) or autograd_aside(
            use_kernel, x, weights):
        return fused_forward_reference(model, x, valid_to, bf16)
    cfg = model.cfg
    if cfg.compute_dtype != "float32":
        raise ValueError(f"the fused forward computes in float32; a "
                         f"{cfg.compute_dtype} model takes the plain path "
                         "(use_kernel=None or False)")
    if not x.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor; the fused "
                         "forward is a CUDA kernel")
    refuse_grad("fused forward", x, weights)
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
    _launch(model, x, valid_to, plan.tile, (mu, logvar, q), bf16, plan.grid)
    with _count_lock:
        fused_forward.launches += 1
        fused_forward.bf16_launches += bf16
    return mu, logvar, q


def _launch(model, x, valid_to, tile: int, out, bf16: bool = False,
            grid: int = 0) -> None:
    """One launch of the kernel at tile width `tile`, in the
    bfloat16-operand mode where bf16 (on `grid` blocks, a block an item
    where 0), into out = (mu, logvar, q).  It does not count:
    fused_forward does."""
    from .fused_encoder import kernel_cache   # it imports this module

    cfg = model.cfg
    B, C, T = x.shape
    H1, H2, K, D = cfg.hidden_dim, cfg.hidden_dim2, cfg.K, cfg.hidden_dim
    lib = _build.library()
    _check_smem(lib, C, H1, H2, K, D, tile, bf16)
    packed, bs = kernel_cache(model).weights(model, x.device, "infer", bf16)
    x = x.contiguous()
    vt = valid_to_rows(valid_to, B, T, x.device)
    if bf16 and not grid:
        grid = B * -(-T // tile)
    err = lib.vqhmm_fused_infer(
        x.data_ptr(), vt.data_ptr(), packed.data_ptr(),
        *[b.data_ptr() for b in bs], *[o.data_ptr() for o in out], B, C, T,
        H1, H2, K, D, tile, int(bf16), grid if bf16 else 0,
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
