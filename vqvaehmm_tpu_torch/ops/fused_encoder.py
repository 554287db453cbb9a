"""Fused encoder: conv3+ReLU -> mask -> conv3+ReLU -> 1x1 regime logits.

Port of the TPU kernel vqvaehmm_tpu/ops/pallas_encoder.py::_encoder_kernel
to a hand-written CUDA kernel for Hopper (csrc/fused_encoder.cu, on the
register-tiled layer of csrc/tile_fma.cuh through csrc/encoder_fma.cuh,
whose headers set out the design and the bound it meets).  `fused_encode`
is the wrapper, `fused_encode_reference` its plain PyTorch version,
`encode_supported` its gate and `encode_plan` its launch plan.  It serves
the inference path (posterior extraction for the backtester and bulk
scoring); its outputs carry no gradient.

The encoder and the evidence kernel (ops/fused_decode.py) share what is
kept a model (`kernel_cache`): the weights packed in the kernels' staging
order, keyed on the parameters' `_version`, storage and device, so that
a request or a posterior call does not pack them again (a model made
under `torch.inference_mode` has parameters without a version: they are
packed every call); the gates' answers; and the launch plans of the
shapes seen.

Dispatch is that of ops/fused_infer.py (`kernel_route`):
`use_kernel=None` takes the kernel for a CUDA tensor of a float32 model
and the plain version for a CPU tensor or a bfloat16 model,
`use_kernel=True` on a CPU tensor or a bfloat16 model raises,
`use_kernel=False` computes the plain version.  There is no fallback: a
call that takes the kernel launches it or raises.  One such exception:
with grad mode on and x or the encoder's weights requiring grad the
kernel refuses, so that no caller trains through a detached tensor
unawares.
`fused_encode.launches` counts the kernel's launches (the pack kernel,
once a weight version, is not counted).
"""

from __future__ import annotations

import threading
import weakref
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .fused_infer import H100_SMS, SMEM_LIMIT, kernel_route, valid_to_rows

# csrc/encoder_fma.cuh and tile_fma.cuh: the tile widths, the halo of the
# two k=3 convolutions, the steps a thread computes, the threads a block
# at most, the floats of one weight buffer and the pad of the rows
TILES = (64, 32, 16)
HALO = 2
JB = 4
MAX_THREADS = 512
WBUF = 6144
ROW_PAD = 8
# an SM of an H100: shared memory and registers, and the kernels' register
# cap (__launch_bounds__(MAX_THREADS, 2): 64 a thread)
_SM_SMEM = 228 * 1024
_SM_REGS = 65536
_REGS = 64
_SM_THREADS = 2048
# a block's fixed cost in steps (fused_train.py's plan): staging, barriers
_FIXED_STEPS = 32
# the cost of an evidence block that runs one of the two stages against
# one that runs both (measured on an H100 at the four main-path shapes:
# 0.55-0.65)
_SPLIT_COST = 0.6

_count_lock = threading.Lock()


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def row_stride(tile: int) -> int:
    """Floats a row of a block's window buffers."""
    return tile + 2 * HALO + JB


def window_rows(C: int, H1: int, H2: int, K: int, U: int = 0,
                HP: int = 0) -> int:
    """Rows of a block's window buffers (csrc/encoder_fma.cuh): the stage
    region, max(C + H1 + H2, U + HP), then K rows of regime logits and, for
    the evidence (HP > 0), K * K rows of transition logits."""
    return max(C + H1 + H2, U + HP) + K + (K * K if HP > 0 else 0)


def smem_dims_bytes(tile: int, dims: Tuple[int, ...]) -> int:
    """Dynamic shared memory of a block at tile width `tile` (the count of
    encoder_fma.cuh::smem_bytes): two weight buffers, a pad, the rows."""
    return 4 * (2 * WBUF + ROW_PAD + row_stride(tile) * window_rows(*dims))


def packed_floats(C: int, H1: int, H2: int, K: int, U: int = 0,
                  HP: int = 0) -> int:
    """Floats of the packed weights (encoder_fma.cuh::packed): I * taps rows
    of round4(O) a layer."""
    return (C * 3 * _round4(H1) + H1 * 3 * _round4(H2) + H2 * _round4(K)
            + U * _round4(HP) + HP * _round4(K * K))


def layers_fit(C: int, H1: int, H2: int, K: int, U: int = 0,
               HP: int = 0) -> bool:
    """Every layer's slab of one input channel fits a weight buffer."""
    return (3 * _round4(H1) <= WBUF and 3 * _round4(H2) <= WBUF
            and _round4(K) <= WBUF and _round4(HP) <= WBUF
            and _round4(K * K) <= WBUF)


def block_threads(tile: int, G: int) -> int:
    """Threads of a block (encoder_fma.cuh::block_threads): the 4 x JB
    tiles of the widest register-tiled layer over the fewest rounds of at
    most MAX_THREADS, four warps at least."""
    items = (G + 3) // 4 * (tile // JB + 2)
    rounds = -(-items // MAX_THREADS)
    t = (-(-items // rounds) + 31) // 32 * 32
    return max(t, 128)


def encoder_dims(cfg, prior: bool = False) -> Tuple[int, ...]:
    """(C, H1, H2, K, U, HP) of a model; U = HP = 0 for the encoder alone."""
    return (cfg.input_dim, cfg.hidden_dim, cfg.hidden_dim2, cfg.K,
            cfg.u_dim if prior else 0, cfg.trans_hidden if prior else 0)


def smem_bytes(cfg, tile: int) -> int:
    """Shared memory a block of the encoder kernel uses at tile width
    `tile` (csrc/fused_encoder.cu::vqhmm_fused_encode_smem_bytes)."""
    return smem_dims_bytes(tile, encoder_dims(cfg))


class Plan(NamedTuple):
    tile: int          # output steps a block
    blocks: int        # B * ceil(T / tile), twice that with split
    threads: int       # a block
    smem: int          # dynamic shared memory a block, bytes
    per_sm: int        # blocks an SM holds at once
    split: bool        # evidence: encoder and prior in blocks of their own


def plan_for(B: int, T: int, dims: Tuple[int, ...], sms: int = H100_SMS,
             can_split: bool = False) -> Optional[Plan]:
    """The launch plan at (B, T) for widths `dims`, or None where no tile
    fits a block's shared memory.  As ops/fused_train.py::train_plan
    chooses, the tile is the one whose grid costs least: waves of resident
    blocks (as many an SM as its shared memory, registers and threads
    hold) times the steps a block computes (min(tile, T)), its halo and a
    fixed part; the wider of two that cost the same (its block has more
    threads for the same steps).  With can_split (the evidence), each
    tile is also costed with the encoder and the prior in blocks of their
    own: twice the blocks, each _SPLIT_COST of the time."""
    G = max(dims[1], dims[2], dims[5])
    best = None
    for t in TILES:
        smem = smem_dims_bytes(t, dims)
        if smem > SMEM_LIMIT:
            continue
        threads = block_threads(t, G)
        per_sm = min(_SM_SMEM // (smem + 1024), _SM_REGS // (_REGS * threads),
                     _SM_THREADS // threads)
        blocks = B * -(-T // t)
        for split in (False, True) if can_split else (False,):
            grid = 2 * blocks if split else blocks
            waves = -(-grid // (sms * per_sm))
            cost = waves * (min(t, T) + 2 * HALO + _FIXED_STEPS) * (
                _SPLIT_COST if split else 1.0)
            if best is None or cost < best[0]:
                best = (cost, Plan(t, grid, threads, smem, per_sm, split))
    return None if best is None else best[1]


def encode_plan(cfg, B: int, T: int, sms: int = H100_SMS) -> Optional[Plan]:
    return plan_for(B, T, encoder_dims(cfg), sms)


def encode_supported(cfg, B: int, T: int) -> bool:
    """True when the encoder kernel takes this model on Hopper: float32
    compute, every layer's slab of one input channel within a weight
    buffer, and a block's rows within a block's shared memory at the
    narrowest tile.  The kernel tiles along T, so B and T set no bound
    beyond the grid's."""
    dims = encoder_dims(cfg)
    return (cfg.compute_dtype == "float32" and B >= 0 and T >= 0
            and layers_fit(*dims)
            and smem_dims_bytes(TILES[-1], dims) <= SMEM_LIMIT)


# ---------------------------------------------------------------------------
# What the encoder and evidence kernels keep a model
# ---------------------------------------------------------------------------


def _kernel_tensors(model):
    """The tensors the two kernels read: the encoder's three layers and,
    where the model has u-conditioned transitions, the prior's two, as
    (weights, biases)."""
    enc = model.encoder
    ws = [enc.conv1.weight, enc.conv2.weight, enc.to_logits.weight]
    bs = [enc.conv1.bias, enc.conv2.bias, enc.to_logits.bias]
    if model.cfg.u_dim is not None:
        net = model.prior_module.transition_net
        ws += [net[0].weight, net[2].weight]
        bs += [net[0].bias, net[2].bias]
    return ws, bs


class KernelCache:
    """One model's packed weights (valid while `key` holds), the gates'
    answers and the launch plans of the shapes seen."""

    def __init__(self):
        self.lock = threading.Lock()
        self.key = None
        self.packed = None
        self.biases = None
        self.gates = {}
        self.plans = {}

    def supported(self, what: str, cfg, gate) -> bool:
        """gate(cfg, 0, 0), asked once a model (the gates' bounds depend on
        the widths alone)."""
        if what not in self.gates:
            self.gates[what] = bool(gate(cfg, 0, 0))
        return self.gates[what]

    def plan(self, what: str, dims, B: int, T: int, device,
             can_split: bool = False) -> Plan:
        """The plan at (B, T), computed once a shape and held once against
        the built library's shared-memory count."""
        sms = _build.sm_count(device)
        key = (what, B, T, sms)
        if key not in self.plans:
            plan = plan_for(B, T, dims, sms, can_split)
            if plan is None:
                raise ValueError(f"no tile of {TILES} fits {what} at widths "
                                 f"{dims} in {SMEM_LIMIT} bytes")
            lib = _build.library()
            got = (lib.vqhmm_fused_encode_smem_bytes(*dims[:4], plan.tile)
                   if what == "encode" else
                   lib.vqhmm_fused_evidence_smem_bytes(*dims, plan.tile))
            if got != plan.smem:
                raise RuntimeError(f"{what} kernel and wrapper disagree on "
                                   f"the shared memory at tile {plan.tile}: "
                                   f"{got} != {plan.smem} bytes")
            self.plans[key] = plan
        return self.plans[key]

    def weights(self, model, device) -> Tuple[torch.Tensor, list]:
        """(packed weights, the biases) on `device`, packed again by the
        pack kernel where a parameter changed since the last pack."""
        ws, bs = _kernel_tensors(model)
        # an inference tensor (a model made under torch.inference_mode)
        # keeps no version: its weights are packed again every call
        key = None if any(p.is_inference() for p in ws + bs) else (
            device, tuple((p._version, p.data_ptr()) for p in ws + bs))
        with self.lock:
            if key is None or key != self.key:
                ws = [w.detach() for w in ws]
                bs = [b.detach() for b in bs]
                for w in ws + bs:
                    if w.device != device or w.dtype != torch.float32 \
                            or not w.is_contiguous():
                        raise ValueError(
                            "model weights must be contiguous float32 on "
                            f"{device} (got {w.dtype} on {w.device})")
                dims = encoder_dims(model.cfg, len(ws) == 5)
                lib = _build.library()
                n = lib.vqhmm_encoder_packed_floats(*dims)
                if n != packed_floats(*dims):
                    raise RuntimeError("encoder pack kernel and wrapper "
                                       f"disagree: {n} packed floats")
                packed = torch.empty(n, dtype=torch.float32, device=device)
                pw = [ws[3].data_ptr(), ws[4].data_ptr()] if len(ws) == 5 \
                    else [None, None]
                stream = torch.cuda.current_stream(device)
                err = lib.vqhmm_encoder_pack(
                    *[w.data_ptr() for w in ws[:3]], *pw, packed.data_ptr(),
                    *dims, stream.cuda_stream)
                _build.check(err, "encoder pack kernel launch")
                if key is None:
                    return packed, bs
                # a caller on another stream must find the pack done
                stream.synchronize()
                self.key, self.packed, self.biases = key, packed, bs
            return self.packed, self.biases


_caches: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_caches_lock = threading.Lock()


def kernel_cache(model) -> KernelCache:
    """The KernelCache of `model`, made at its first use; it goes with the
    model."""
    with _caches_lock:
        cache = _caches.get(model)
        if cache is None:
            cache = _caches[model] = KernelCache()
        return cache


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------


def fused_encode_reference(model, x: torch.Tensor,
                           valid_to=None) -> torch.Tensor:
    """Plain version: the model's own convolution stack, (B, K, T)."""
    return model.encode(x, valid_to=valid_to, fused=False)


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
    if not kernel_route(model, x, use_kernel):
        return fused_encode_reference(model, x, valid_to)
    if not x.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor; the fused "
                         "encoder is a CUDA kernel")
    cfg = model.cfg
    refuse_grad("fused encoder", x, model.encoder.parameters())
    check_x(model, x, "fused encoder")
    cache = kernel_cache(model)
    B, C, T = x.shape
    if not cache.supported("encode", cfg, encode_supported):
        raise ValueError(
            f"fused encoder unsupported for {cfg}: it computes in float32, "
            f"takes hidden widths up to {WBUF // 3} and needs "
            f"{smem_bytes(cfg, TILES[-1])} bytes of shared memory a block, "
            f"of at most {SMEM_LIMIT} (see encode_supported)")
    vt = valid_to_rows(valid_to, B, T, x.device)
    logits = torch.empty((B, cfg.K, T), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return logits
    plan = cache.plan("encode", encoder_dims(cfg), B, T, x.device)
    _launch(model, x, vt, plan.tile, logits)
    with _count_lock:
        fused_encode.launches += 1
    return logits


def _launch(model, x, vt, tile: int, logits) -> None:
    """One launch of the kernel at tile width `tile` into `logits`, vt the
    (B,) int32 bound.  It does not count: fused_encode does."""
    cfg = model.cfg
    B, C, T = x.shape
    packed, bs = kernel_cache(model).weights(model, x.device)
    x = x.contiguous()
    err = _build.library().vqhmm_fused_encode(
        x.data_ptr(), vt.data_ptr(), packed.data_ptr(),
        *[b.data_ptr() for b in bs[:3]], logits.data_ptr(), B, C, T,
        cfg.hidden_dim, cfg.hidden_dim2, cfg.K, tile,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_encoder kernel launch")


fused_encode.launches = 0
