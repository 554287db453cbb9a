"""Fused encoder: conv3+ReLU -> mask -> conv3+ReLU -> 1x1 regime logits.

Port of the TPU kernel vqvaehmm_tpu/ops/pallas_encoder.py::_encoder_kernel
to a hand-written CUDA kernel for Hopper (csrc/fused_encoder.cu, on the
register-tiled layer of csrc/tile_fma.cuh through csrc/encoder_fma.cuh,
whose headers set out the design and the bound it meets).  `fused_encode`
is the wrapper, `fused_encode_reference` its plain PyTorch version,
`encode_supported` its gate and `encode_plan` its launch plan.  It serves
the inference path (posterior extraction for the backtester and bulk
scoring); its outputs carry no gradient.

The encoder, the evidence kernel (ops/fused_decode.py) and the serving
forward (ops/fused_infer.py) keep what they need a model in
`kernel_cache`: the weights packed in the kernels' order, a pack a
kernel family and mode, keyed on the parameters' `_version`, storage and
device, so that a request or a posterior call does not pack them again (a
model made under `torch.inference_mode` has parameters without a
version: they are packed every call); the gates' answers; and the launch
plans of the shapes seen.

Two modes of arithmetic, as the TPU kernel's `highest` flag has
(ops/fused_train.py::infer_bf16_mode, ops/fused_infer.py::operand_mode):
float32, and on a CUDA tensor of a float32 model whose matmul_precision
is not "highest" the bfloat16-operand mode (both operands of every
product rounded to bfloat16, float32 sums, on the tensor cores:
csrc/encoder_mma.cuh), whose plain version is
`fused_encode_reference(bf16_operands=True)`; `use_kernel=False` takes
that plain version on the card.  Each mode has its own plan, shared
memory and gate (`encode_supported(..., bf16=True)`); a model the mode's
gate refuses raises.

Dispatch is that of ops/fused_infer.py (`kernel_route`):
`use_kernel=None` takes the kernel for a CUDA tensor of a float32 model
and the plain version for a CPU tensor or a bfloat16 model,
`use_kernel=True` on a CPU tensor or a bfloat16 model raises,
`use_kernel=False` computes the plain version, and so does
`use_kernel=None` for a call that autograd would record (grad mode on and
x or the encoder's weights requiring grad), where `use_kernel=True`
raises: no caller trains through a detached tensor unawares.  There is
no fallback: a call that takes the kernel launches it or raises.
`fused_encode.launches` counts the kernel's launches in either mode (the
pack kernel, once a weight version and mode, is not counted),
`fused_encode.bf16_launches` those in the bfloat16-operand mode,
`fused_encode.staged_launches` those of them that ran its second design
(the weights staged in shared memory, `encode_design`).  KernelCache's
misses are counted and spanned (utils/profiling.py): a plan made is a
`cache.plan` (`counts.plans_made`), a pack a `cache.pack`
(`counts.packs_made`), and the synchronise after a kept pack a
`host.sync`.
"""

from __future__ import annotations

import threading
import weakref
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.profiling import counted, host_sync
from . import _build
from .fused_infer import (H100_SMS, SM_SMEM, SMEM_LIMIT, StagePlan,
                          _op_stride, autograd_aside, kernel_route,
                          operand_mode, refuse_grad, stage_plan,
                          valid_to_rows)
from .fused_infer import packed_bf16 as infer_packed_bf16
from .fused_infer import packed_floats as infer_packed_floats

# csrc/encoder_fma.cuh and tile_fma.cuh: the tile widths, the halo of the
# two k=3 convolutions, the steps a thread computes, the threads a block
# at most, the floats of one weight buffer and the pad of the rows
TILES = (64, 32, 16)
HALO = 2
JB = 4
MAX_THREADS = 512
WBUF = 6144
ROW_PAD = 8
# an SM of an H100: registers, and the kernels' register cap
# (__launch_bounds__(MAX_THREADS, 2): 64 a thread)
_SM_REGS = 65536
_REGS = 64
_SM_THREADS = 2048
# a block's fixed cost in steps (fused_train.py's plan): staging, barriers
_FIXED_STEPS = 32
# the cost of an evidence block that runs one of the two stages against
# one that runs both (measured on an H100 at the four main-path shapes:
# 0.55-0.65)
_SPLIT_COST = 0.6
# the bfloat16-operand mode's blocks (csrc/encoder_mma.cuh): THREADS
# threads, at most BLOCKS_PER_SM resident an SM; the encoder's second
# design at most STAGED_BLOCKS_PER_SM (csrc/fused_encoder.cu)
MMA_THREADS = 256
MMA_BLOCKS_PER_SM = 3
STAGED_BLOCKS_PER_SM = 2
# the most steps a block of the encoder computes for its plan to take the
# second design (`encode_design`)
STAGED_STEPS = 32

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


def smem_dims_bytes(tile: int, dims: Tuple[int, ...],
                    bf16: bool = False) -> int:
    """Dynamic shared memory of a block at tile width `tile` (the count of
    encoder_fma.cuh::smem_bytes): two weight buffers, a pad, the rows.
    bf16 (encoder_mma.cuh::smem_bytes): bfloat16 operands of tile + 2 HALO
    rows, x, u where HP > 0, two ping-pong buffers of the widest of H1, H2
    and HP; then, where HP > 0, K + K * K float32 rows."""
    if bf16:
        C, H1, H2, K, U, HP = dims
        ops = _op_stride(C) + (_op_stride(U) if HP > 0 else 0) \
            + 2 * _op_stride(max(H1, H2, HP))
        return (2 * (tile + 2 * HALO) * ops
                + 4 * row_stride(tile) * (K + K * K if HP > 0 else 0))
    return 4 * (2 * WBUF + ROW_PAD + row_stride(tile) * window_rows(*dims))


def packed_floats(C: int, H1: int, H2: int, K: int, U: int = 0,
                  HP: int = 0) -> int:
    """Floats of the packed weights (encoder_fma.cuh::packed): I * taps rows
    of round4(O) a layer."""
    return (C * 3 * _round4(H1) + H1 * 3 * _round4(H2) + H2 * _round4(K)
            + U * _round4(HP) + HP * _round4(K * K))


def layers(C: int, H1: int, H2: int, K: int, U: int = 0, HP: int = 0):
    """(O, I, taps) of the packed layers in order: the encoder's three,
    then, where HP > 0, the prior's two."""
    enc = ((H1, C, 3), (H2, H1, 3), (K, H2, 1))
    return enc + (((HP, U, 1), (K * K, HP, 1)) if HP > 0 else ())


def packed_bf16(C: int, H1: int, H2: int, K: int, U: int = 0,
                HP: int = 0) -> int:
    """bfloat16 values of the bfloat16 mode's packed weights
    (encoder_mma.cuh::packed): round16(O) x taps x round16(I) a layer, in
    mma fragment order."""
    return sum(-(-O // 16) * 16 * taps * -(-I // 16) * 16
               for O, I, taps in layers(C, H1, H2, K, U, HP))


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


def smem_bytes(cfg, tile: int, bf16: bool = False) -> int:
    """Shared memory a block of the encoder kernel uses at tile width
    `tile` in the mode (csrc/fused_encoder.cu::
    vqhmm_fused_encode_smem_bytes)."""
    return smem_dims_bytes(tile, encoder_dims(cfg), bf16)


class Plan(NamedTuple):
    tile: int          # output steps a block
    blocks: int        # items: B * ceil(T / tile), twice that with split
    threads: int       # a block
    smem: int          # dynamic shared memory a block, bytes
    per_sm: int        # blocks an SM holds at once
    split: bool        # evidence: encoder and prior in blocks of their own
    weights: str = ""  # the bfloat16 mode of the evidence and the encoder:
    #                    where its weights are (ops/fused_infer.py::
    #                    stage_plan)
    grid: int = 0      # the encoder's bfloat16 mode: blocks of its second
    #                    design (a persistent grid where its weights are
    #                    resident); 0 for the first design, a block an item


def evidence_stage(tile: int, dims: Tuple[int, ...], staged: bool = True):
    """Where a block of the evidence's bfloat16 mode keeps its weights
    (csrc/fused_decode.cu::evidence_stage): after its operands
    (`smem_dims_bytes`), where `staged`, the five layers' packed values as
    `stage_plan` places them; else none, read from L2 ("direct")."""
    ops = smem_dims_bytes(tile, dims, True)
    if not staged:
        return StagePlan("direct", 0, ops)
    return stage_plan(ops, 0, packed_bf16(*dims))


def encode_stage(tile: int, dims: Tuple[int, ...]) -> StagePlan:
    """Where a block of the encoder's second bfloat16-mode design keeps its
    weights (csrc/fused_encoder.cu::encode_stage): after its operands
    (`smem_dims_bytes`), resident with the next item's raw x window (C
    rows of tile + 2 HALO floats), else on a ring, else nowhere ("direct":
    the first design's block, which reads them from L2)."""
    return stage_plan(smem_dims_bytes(tile, dims, True),
                      4 * dims[0] * (tile + 2 * HALO), packed_bf16(*dims))


def encode_staged(plan: Plan, dims: Tuple[int, ...],
                  sms: int = H100_SMS) -> Optional[Plan]:
    """The encoder's second bfloat16-mode design at the first design's
    tile (`plan_for`): its weights resident or on a ring
    (`encode_stage`), on a grid of the blocks that stay resident where they
    are resident (each stages them once and walks its items), a block an
    item on a ring; None where not even two ring slots fit."""
    stage = encode_stage(plan.tile, dims)
    if stage.weights == "direct":
        return None
    per_sm = min(SM_SMEM // (stage.bytes + 1024), STAGED_BLOCKS_PER_SM)
    grid = plan.blocks if stage.weights == "ring" else min(
        plan.blocks, per_sm * sms)
    return plan._replace(smem=stage.bytes, per_sm=per_sm,
                         weights=stage.weights, grid=grid)


def encode_design(plan: Plan, dims: Tuple[int, ...], T: int,
                  sms: int = H100_SMS) -> Plan:
    """The encoder's bfloat16-mode plan at (B, T) with the design it runs:
    the second (`encode_staged`) where it exists and a block computes at
    most STAGED_STEPS steps (min(tile, T)), else the first (weights
    "direct", read from L2, grid 0).  As measured on an H100 (PERF.md): a
    block of few steps does few mma a weight fragment, so each layer
    waits on its fragments from L2 and staging them pays (at (1, 200) and
    (460, 20), blocks of 16 and 20 steps); a block of 64 steps does up to
    six, which hide that wait, and its copy of the weights cost more than
    it saved (at (64, 200))."""
    staged = encode_staged(plan, dims, sms)
    if staged is None or min(plan.tile, T) > STAGED_STEPS:
        return plan._replace(weights="direct", grid=0)
    return staged


def plan_for(B: int, T: int, dims: Tuple[int, ...], sms: int = H100_SMS,
             can_split: bool = False, bf16: bool = False,
             staged: bool = False) -> Optional[Plan]:
    """The launch plan at (B, T) for widths `dims` in the mode, or None
    where no tile fits a block's shared memory.  As
    ops/fused_train.py::train_plan chooses, the tile is the one whose grid
    costs least: waves of resident blocks (as many an SM as its shared
    memory, registers and threads hold; in the bfloat16 mode, blocks of
    MMA_THREADS, at most MMA_BLOCKS_PER_SM) times the steps a block
    computes (min(tile, T)), its halo and a fixed part; the wider of two
    that cost the same (its block has more threads for the same steps).
    With can_split (the evidence), each tile is also costed with the
    encoder and the prior in blocks of their own: twice the blocks, each
    _SPLIT_COST of the time.  staged (the evidence's bfloat16 mode): where
    the grid leaves an SM a block at most, a block's shared memory holds
    its weights too (`evidence_stage`); on a larger grid they are read
    from L2 (PERF.md: staging them there was slower)."""
    G = max(dims[1], dims[2], dims[5])
    best = None
    for t in TILES:
        if smem_dims_bytes(t, dims, bf16) > SMEM_LIMIT:
            continue
        blocks = B * -(-T // t)
        for split in (False, True) if can_split else (False,):
            grid = 2 * blocks if split else blocks
            stage = evidence_stage(t, dims, grid <= sms) if staged else None
            smem = stage.bytes if staged else smem_dims_bytes(t, dims, bf16)
            if bf16:
                threads = MMA_THREADS
                per_sm = min(SM_SMEM // (smem + 1024), MMA_BLOCKS_PER_SM)
            else:
                threads = block_threads(t, G)
                per_sm = min(SM_SMEM // (smem + 1024),
                             _SM_REGS // (_REGS * threads),
                             _SM_THREADS // threads)
            waves = -(-grid // (sms * per_sm))
            cost = waves * (min(t, T) + 2 * HALO + _FIXED_STEPS) * (
                _SPLIT_COST if split else 1.0)
            if best is None or cost < best[0]:
                best = (cost, Plan(t, grid, threads, smem, per_sm, split,
                                   stage.weights if staged else ""))
    return None if best is None else best[1]


def encode_plan(cfg, B: int, T: int, sms: int = H100_SMS,
                bf16: bool = False) -> Optional[Plan]:
    """The encoder's plan at (B, T) in the mode: the tile of `plan_for`,
    and in the bfloat16 mode the design `encode_design` takes."""
    dims = encoder_dims(cfg)
    plan = plan_for(B, T, dims, sms, bf16=bf16)
    return plan if plan is None or not bf16 else encode_design(plan, dims,
                                                               T, sms)


def encode_supported(cfg, B: int, T: int, bf16: bool = False) -> bool:
    """True when the encoder kernel takes this model on Hopper in the mode:
    float32 compute, in the float32 mode every layer's slab of one input
    channel within a weight buffer (the bfloat16 mode stages no weights),
    and a block's rows within a block's shared memory at the narrowest
    tile.  The kernel tiles along T, so B and T set no bound beyond the
    grid's."""
    dims = encoder_dims(cfg)
    return (cfg.compute_dtype == "float32" and B >= 0 and T >= 0
            and (bf16 or layers_fit(*dims))
            and smem_dims_bytes(TILES[-1], dims, bf16) <= SMEM_LIMIT)


# ---------------------------------------------------------------------------
# What the encoder and evidence kernels keep a model
# ---------------------------------------------------------------------------


def _kernel_tensors(model, what: str):
    """The tensors a kernel family reads, as (weights, biases): for
    "encoder" (kernels 8, 10, 11) the encoder's three layers and, where
    the model has u-conditioned transitions, the prior's two; for "infer"
    (kernel A) the encoder's three layers, the codebook and the decoder's
    three."""
    enc = model.encoder
    ws = [enc.conv1.weight, enc.conv2.weight, enc.to_logits.weight]
    bs = [enc.conv1.bias, enc.conv2.bias, enc.to_logits.bias]
    if what == "infer":
        dec = model.decoder
        ws += [dec.embeddings.weight, dec.conv1.weight, dec.conv2.weight,
               dec.to_params.weight]
        bs += [dec.conv1.bias, dec.conv2.bias, dec.to_params.bias]
    elif model.cfg.u_dim is not None:
        net = model.prior_module.transition_net
        ws += [net[0].weight, net[2].weight]
        bs += [net[0].bias, net[2].bias]
    return ws, bs


def _pack(lib, model, what: str, bf16: bool, ws, device) -> torch.Tensor:
    """The weights `ws` of `what` packed by the library's pack kernel in
    the mode, on the current stream: floats in tile_fma.cuh's staging
    order, or bfloat16 values in tile_mma.cuh's fragment order.  The
    library's count of packed values is held against the wrapper's."""
    cfg = model.cfg
    if what == "infer":
        dims = (cfg.input_dim, cfg.hidden_dim, cfg.hidden_dim2, cfg.K,
                cfg.hidden_dim)
        n = lib.vqhmm_fused_infer_packed_floats(*dims, int(bf16))
        want = (infer_packed_bf16 if bf16 else infer_packed_floats)(*dims)
    else:
        dims = encoder_dims(cfg, len(ws) == 5)
        n = lib.vqhmm_encoder_packed_floats(*dims, int(bf16))
        want = (packed_bf16 if bf16 else packed_floats)(*dims)
    if n != want:
        raise RuntimeError(f"{what} pack kernel and wrapper disagree: {n} "
                           f"packed values, {want} expected (bf16={bf16})")
    packed = torch.empty(n, dtype=torch.bfloat16 if bf16 else torch.float32,
                         device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    if what == "infer":
        err = lib.vqhmm_fused_infer_pack(
            *[w.data_ptr() for w in ws], packed.data_ptr(), *dims, int(bf16),
            stream)
    else:
        pw = [ws[3].data_ptr(), ws[4].data_ptr()] if len(ws) == 5 \
            else [None, None]
        err = lib.vqhmm_encoder_pack(*[w.data_ptr() for w in ws[:3]], *pw,
                                     packed.data_ptr(), *dims, int(bf16),
                                     stream)
    _build.check(err, f"{what} pack kernel launch")
    return packed


class KernelCache:
    """One model's packed weights, a (kernel family, mode) each and valid
    while its key holds, the gates' answers and the launch plans of the
    shapes seen."""

    def __init__(self):
        self.lock = threading.Lock()
        # (what, bf16) -> (key, packed, biases)
        self.packs = {}
        self.gates = {}
        self.plans = {}

    def supported(self, what: str, cfg, gate) -> bool:
        """gate(cfg, 0, 0), asked once a model (the gates' bounds depend on
        the widths alone)."""
        if what not in self.gates:
            self.gates[what] = bool(gate(cfg, 0, 0))
        return self.gates[what]

    def plan(self, what: str, dims, B: int, T: int, device,
             can_split: bool = False, bf16: bool = False) -> Plan:
        """The plan at (B, T) in the mode, computed once a shape and held
        once against the built library's shared-memory count (the
        evidence's bfloat16 mode stages its weights: plan_for's
        `staged`; the decode's plan, whose tile alone is taken from here,
        is held against the library by ops/fused_decode.py::
        decode_plan)."""
        sms = _build.sm_count(device)
        key = (what, bf16, B, T, sms)
        if key in self.plans:
            return self.plans[key]
        with counted("cache.plan", "plans_made"):
            plan = plan_for(B, T, dims, sms, can_split, bf16,
                            staged=bf16 and what == "evidence")
            if plan is not None and bf16 and what == "encode":
                plan = encode_design(plan, dims, T, sms)
            if plan is None:
                raise ValueError(f"no tile of {TILES} fits {what} at widths "
                                 f"{dims} in {SMEM_LIMIT} bytes (bf16="
                                 f"{bf16})")
            lib = _build.library()
            if what == "encode":
                got = lib.vqhmm_fused_encode_smem_bytes(
                    *dims[:4], plan.tile, int(bf16), int(plan.grid > 0))
            elif what == "evidence":
                got = lib.vqhmm_fused_evidence_smem_bytes(
                    *dims, plan.tile, int(bf16),
                    int(plan.weights != "direct"))
            else:
                got = plan.smem
            if got != plan.smem:
                raise RuntimeError(f"{what} kernel and wrapper disagree on "
                                   f"the shared memory at tile {plan.tile} "
                                   f"(bf16={bf16}): {got} != {plan.smem} "
                                   "bytes")
            self.plans[key] = plan
        return self.plans[key]

    def weights(self, model, device, what: str = "encoder",
                bf16: bool = False) -> Tuple[torch.Tensor, list]:
        """(packed weights, the biases) of `what` ("encoder": kernels 8, 10
        and 11; "infer": kernel A) in the mode on `device`, packed again by
        the pack kernel where a parameter changed since the last pack."""
        ws, bs = _kernel_tensors(model, what)
        # an inference tensor (a model made under torch.inference_mode)
        # keeps no version: its weights are packed again every call
        key = None if any(p.is_inference() for p in ws + bs) else (
            device, tuple((p._version, p.data_ptr()) for p in ws + bs))
        with self.lock:
            kept = self.packs.get((what, bf16))
            if key is not None and kept is not None and kept[0] == key:
                return kept[1], kept[2]
            ws = [w.detach() for w in ws]
            bs = [b.detach() for b in bs]
            for w in ws + bs:
                if w.device != device or w.dtype != torch.float32 \
                        or not w.is_contiguous():
                    raise ValueError(
                        "model weights must be contiguous float32 on "
                        f"{device} (got {w.dtype} on {w.device})")
            with counted("cache.pack", "packs_made"):
                packed = _pack(_build.library(), model, what, bf16, ws,
                               device)
                if key is None:
                    return packed, bs
                # a caller on another stream must find the pack done: the
                # host waits for the device here
                with host_sync(device):
                    torch.cuda.current_stream(device).synchronize()
            self.packs[(what, bf16)] = (key, packed, bs)
            return packed, bs


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


def fused_encode_reference(model, x: torch.Tensor, valid_to=None,
                           bf16_operands: bool = False) -> torch.Tensor:
    """Plain version: the model's own convolution stack, (B, K, T);
    bf16_operands: the bfloat16-operand mode's
    (VAEHMM.encode(bf16_operands=True))."""
    return model._encode_stack(x, valid_to, bf16_operands)


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
    bf16 = operand_mode(model, x)
    weights = list(model.encoder.parameters())
    if not kernel_route(model, x, use_kernel) or autograd_aside(
            use_kernel, x, weights):
        return fused_encode_reference(model, x, valid_to, bf16)
    if not x.is_cuda:
        raise ValueError("use_kernel=True needs a CUDA tensor; the fused "
                         "encoder is a CUDA kernel")
    cfg = model.cfg
    refuse_grad("fused encoder", x, weights)
    check_x(model, x, "fused encoder")
    cache = kernel_cache(model)
    B, C, T = x.shape
    gate = "encode_bf16" if bf16 else "encode"
    if not cache.supported(gate, cfg, lambda c, b, t: encode_supported(
            c, b, t, bf16)):
        mode = ("in its bfloat16-operand mode" if bf16 else
                f"in float32, takes hidden widths up to {WBUF // 3}")
        raise ValueError(
            f"fused encoder unsupported for {cfg}: it computes {mode} and "
            f"needs {smem_bytes(cfg, TILES[-1], bf16)} bytes of shared "
            f"memory a block, of at most {SMEM_LIMIT} (see "
            "encode_supported)")
    vt = valid_to_rows(valid_to, B, T, x.device)
    logits = torch.empty((B, cfg.K, T), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return logits
    plan = cache.plan("encode", encoder_dims(cfg), B, T, x.device, bf16=bf16)
    _launch(model, x, vt, plan.tile, logits, bf16, plan.grid)
    with _count_lock:
        fused_encode.launches += 1
        fused_encode.bf16_launches += bf16
        fused_encode.staged_launches += plan.grid > 0
    return logits


def _launch(model, x, vt, tile: int, logits, bf16: bool = False,
            grid: int = 0) -> None:
    """One launch of the kernel at tile width `tile`, in the
    bfloat16-operand mode where bf16 (its second design on `grid` blocks
    where grid > 0, its first where 0), into `logits`, vt the (B,) int32
    bound.  It does not count: fused_encode does."""
    cfg = model.cfg
    B, C, T = x.shape
    packed, bs = kernel_cache(model).weights(model, x.device, bf16=bf16)
    x = x.contiguous()
    err = _build.library().vqhmm_fused_encode(
        x.data_ptr(), vt.data_ptr(), packed.data_ptr(),
        *[b.data_ptr() for b in bs[:3]], logits.data_ptr(), B, C, T,
        cfg.hidden_dim, cfg.hidden_dim2, cfg.K, tile, int(bf16), grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_encoder kernel launch")


fused_encode.launches = 0
fused_encode.bf16_launches = 0
fused_encode.staged_launches = 0
