"""The HMM evidence in one kernel, and the one-kernel Viterbi decode.

Port of the two TPU kernels of vqvaehmm_tpu/ops/pallas_decode.py to
hand-written CUDA kernels for Hopper (csrc/fused_decode.cu, whose header
sets out their designs and the bounds they meet):

* `fused_evidence` (replaces `_evidence_kernel`): the one-kernel twin of
  `VAEHMM.prior` plus `VAEHMM._hmm_evidence`, returning `(log_pi (K,),
  log_A (B, T, K, K), log_obs (B, T, K))` ready for ops/hmm.py and the
  Viterbi kernel.  No length masking: ops/hmm.py applies it downstream.
  Only on request (`inert_past_length=True`, which
  `VAEHMM.viterbi_decode` alone sets: its scan replaces every step past a
  sequence's length by the inert step) the kernel leaves each tile that
  starts at or past its sequence's length inert, log_obs 0 and log_A the
  identity, and computes nothing there; every other step is computed as
  without it.  The plain version computes every step either way.
* `fused_viterbi_states` (replaces `_kernel`): the MAP path (B, T) int32
  from raw (x, u) in one launch, the evidence never reaching device
  memory.  Past each sequence's length the path is frozen at its last
  valid state.  Its evidence is kernel 11's and its recursion the
  segmented max-plus scan of the Viterbi kernel (csrc/maxplus_scan.cuh),
  so its states are bit-equal to `fused_evidence` followed by
  ops/fused_viterbi.py::viterbi_fused.

`fused_evidence_reference` and `fused_viterbi_states_reference` are their
plain PyTorch versions, `supported` their gate, `evidence_plan` the
evidence kernel's launch plan (ops/fused_encoder.py::plan_for, with the
encoder and the prior in blocks of their own where the grid is small) and
`decode_plan` the decode's (a cooperative launch of persistent blocks,
each holding `ntb` tiles, sized by the occupancy the runtime reports).
Both bound the encoder at the scalar max(lengths), as the model's exact
modes do, and read the weights the encoder kernel's pack kernel lays out,
kept a model (ops/fused_encoder.py::kernel_cache).

Dispatch is that of ops/fused_infer.py (`kernel_route`):
`use_kernel=None` takes the kernel for a CUDA tensor of a float32 model
and the plain version for a CPU tensor or a bfloat16 model,
`use_kernel=True` on a CPU tensor or a bfloat16 model raises,
`use_kernel=False` computes the plain version, and so does
`use_kernel=None` for a call that autograd would record (grad mode on and
x, u, or a weight of the encoder or the prior requiring grad), where
`use_kernel=True` raises, for the decode too (its integer states carry no
gradient, but JAX's auto-dispatch routes a differentiating caller around
its decode kernels all the same).  There is no fallback.

Two modes of arithmetic, as the TPU kernels' `highest` flag has
(ops/fused_train.py::infer_bf16_mode, ops/fused_infer.py::operand_mode):
float32, and on a CUDA tensor of a float32 model whose matmul_precision
is not "highest" the bfloat16-operand mode (the evidence stages of
csrc/encoder_mma.cuh on the tensor cores), whose plain versions are the
references with `bf16_operands=True`; `use_kernel=False` takes them on
the card.  Each mode has its own plans, shared memory and gate
(`supported(..., bf16=True)`); a model or shape the mode refuses raises.
`fused_evidence.launches` and `fused_viterbi_states.launches` count the
kernels' launches in either mode, their `.bf16_launches` those in the
bfloat16-operand mode, `fused_evidence.inert_launches` those that left
the tiles past the lengths inert (the flag and `lengths` given), and
`fused_viterbi_states.staged_launches` those of the decode's second design
in that mode (the evidence's weights staged in shared memory once a block,
`decode_plan`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .fused_encoder import (TILES, check_x, encoder_dims, evidence_stage,
                            kernel_cache, layers_fit, plan_for,
                            smem_dims_bytes)
from .fused_infer import (CTRL_BYTES, H100_SMS, SMEM_LIMIT, WEIGHT_KINDS,
                          autograd_aside, kernel_route, operand_mode,
                          refuse_grad)
from .fused_encoder import packed_bf16
from .fused_train import _u_strides
from .fused_viterbi import MAX_K, num_segments
from .hmm import viterbi



def _chunk_floats(K: int) -> int:
    """Floats of a decode block's chunk (csrc/fused_decode.cu::
    chunk_floats)."""
    return max(64 * K * K, 2048)

_count_lock = threading.Lock()


def evidence_stage_bytes(cfg, tile: int, bf16: bool = False) -> int:
    """The evidence stages' shared memory at tile width `tile` in the
    mode, without the weights: the decode's stage region in front of its
    tiles (csrc/encoder_mma.cuh::smem_bytes, encoder_fma.cuh's)."""
    return smem_dims_bytes(tile, encoder_dims(cfg, prior=True), bf16)


def evidence_smem_bytes(cfg, tile: int, bf16: bool = False) -> int:
    """Shared memory an evidence block uses at tile width `tile` in the
    mode (csrc/fused_decode.cu::vqhmm_fused_evidence_smem_bytes): the
    stages' rows; in the bfloat16 mode also its weights, where
    ops/fused_encoder.py::evidence_stage puts them."""
    if bf16:
        return evidence_stage(tile, encoder_dims(cfg, prior=True)).bytes
    return evidence_stage_bytes(cfg, tile)


def evidence_plan(cfg, B: int, T: int, sms: int = H100_SMS,
                  bf16: bool = False):
    return plan_for(B, T, encoder_dims(cfg, prior=True), sms, can_split=True,
                    bf16=bf16, staged=bf16)


def decode_smem_bytes(cfg, tile: int, ntb: int = 1, bf16: bool = False,
                      staged: bool = False) -> int:
    """Shared memory of a decode block at tile width `tile` holding `ntb`
    tiles (csrc/fused_decode.cu::decode_smem): the evidence stage in the
    mode, rounded to 16 bytes; with `staged` (the bfloat16 mode's second
    design) the control region and the five layers' packed values
    (decode_weight_floats); each tile's log_obs, log_A and backpointer
    words; the scratch of the fold and the reverse pass (the chunk that
    stages products and selector maps, 32 chunk products and deltas, 68
    words)."""
    K = cfg.K
    stage = -(-evidence_stage_bytes(cfg, tile, bf16) // 16) * 16
    if staged:
        stage += CTRL_BYTES + 2 * packed_bf16(
            *encoder_dims(cfg, prior=True))
    return stage + 4 * (ntb * tile * (K + K * K + 1) + _chunk_floats(K)
                        + 32 * (K * K + K) + 68)


class DecodePlan(NamedTuple):
    tile: int          # steps a tile
    grid: int          # persistent blocks, all resident at once
    ntb: int           # tiles a block at most
    threads: int       # a block
    smem: int          # dynamic shared memory a block, bytes
    weights: str = "direct"  # the evidence's weights: "direct" (read from
    #                          L2, the first design) or "resident" (the
    #                          bfloat16 mode's second design)


def supported(cfg, B: int, T: int, bf16: bool = False) -> bool:
    """True when the evidence and decode kernels take this model on
    Hopper in the mode: float32 compute, u-conditioned transitions, at
    most MAX_K regimes (4-bit backpointers), in the float32 mode every
    layer's slab of one input channel within a weight buffer of the
    evidence kernel (the bfloat16 mode stages no weights), and a block's
    rows and one tile within a block's shared memory at the narrowest
    tile.  The evidence tiles the time axis, so T sets it no bound; the
    decode keeps every tile resident, so B * T is bounded by its plan
    (`decode_plan`, which raises)."""
    return (cfg.compute_dtype == "float32" and cfg.u_dim is not None
            and B >= 0 and T >= 0 and 1 <= cfg.K <= MAX_K
            and (bf16 or layers_fit(*encoder_dims(cfg, prior=True)))
            and evidence_smem_bytes(cfg, TILES[-1], bf16) <= SMEM_LIMIT
            and decode_smem_bytes(cfg, TILES[-1], 1, bf16) <= SMEM_LIMIT)


def fused_evidence_reference(model, x: torch.Tensor, u: torch.Tensor,
                             lengths: Optional[torch.Tensor] = None,
                             bf16_operands: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Plain version: the model's prior and encoder evidence;
    bf16_operands: the bfloat16-operand mode's."""
    log_pi, log_A = model.prior(u, bf16_operands)
    return log_pi, log_A, model._hmm_evidence(x, lengths, bf16_operands)


def fused_viterbi_states_reference(model, x: torch.Tensor, u: torch.Tensor,
                                   lengths: Optional[torch.Tensor] = None,
                                   bf16_operands: bool = False
                                   ) -> torch.Tensor:
    """Plain version: the plain evidence (in the mode), then the
    sequential decode of ops/hmm.py."""
    return viterbi(*fused_evidence_reference(model, x, u, lengths,
                                             bf16_operands),
                   lengths).states


def _prepare(model, x, u, lengths, what: str, bf16: bool):
    """Checks shared by the two kernels; (x, lengths int32 or None)."""
    cfg = model.cfg
    check_x(model, x, what)
    B, C, T = x.shape
    if not kernel_cache(model).supported(
            "decode_bf16" if bf16 else "decode", cfg,
            lambda c, b, t: supported(c, b, t, bf16)):
        mode = ("in its bfloat16-operand mode" if bf16 else
                "layers whose slab of one input channel fits a weight "
                "buffer")
        raise ValueError(
            f"{what} unsupported for {cfg}: it takes float32, 1 <= K <= "
            f"{MAX_K}, {mode} and at most {SMEM_LIMIT} bytes of shared "
            f"memory a block (needs "
            f"{decode_smem_bytes(cfg, TILES[-1], 1, bf16)} for the decode, "
            f"{evidence_smem_bytes(cfg, TILES[-1], bf16)} "
            "for the evidence; see supported)")
    if u.dtype != torch.float32 or u.device != x.device:
        raise ValueError(f"u must be float32 on {x.device}, got {u.dtype} "
                         f"on {u.device}")
    if u.dim() != 3 or u.shape[0] != B or not (
            tuple(u.shape[1:]) == (cfg.u_dim, T)
            or tuple(u.shape[1:]) == (T, cfg.u_dim)):
        raise ValueError(f"u must be (B, U={cfg.u_dim}, T) or (B, T, U), "
                         f"got {tuple(u.shape)} for x {tuple(x.shape)}")
    lens = None
    if lengths is not None:
        lens = lengths.to(device=x.device, dtype=torch.int32).contiguous()
        if tuple(lens.shape) != (B,):
            raise ValueError(f"lengths must be ({B},), got "
                             f"{tuple(lens.shape)}")
    return x.contiguous(), lens


def evidence_tensors(model, u: torch.Tensor) -> list:
    """The tensors kernels 11 and 10 read besides x: the encoder's and the
    prior's weights, and u."""
    return [*model.encoder.parameters(), *model.prior_module.parameters(),
            u]


def _dims(cfg, B: int, T: int):
    return (B, cfg.input_dim, T, cfg.u_dim, cfg.hidden_dim, cfg.hidden_dim2,
            cfg.K, cfg.trans_hidden)


def fused_evidence(model, x: torch.Tensor, u: torch.Tensor,
                   lengths: Optional[torch.Tensor] = None,
                   use_kernel: Optional[bool] = None,
                   inert_past_length: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(log_pi (K,), log_A (B, T, K, K), log_obs (B, T, K)) for x (B, C, T)
    and u (B, U, T) or (B, T, U), the encoder bounded at max(lengths).
    inert_past_length: on the kernel's route with `lengths`, each tile
    that starts at or past its row's length is left inert, not computed
    (see the module's docstring); the plain route ignores it."""
    bf16 = operand_mode(model, x)
    tensors = evidence_tensors(model, u)
    if not kernel_route(model, x, use_kernel) or autograd_aside(
            use_kernel, x, tensors):
        return fused_evidence_reference(model, x, u, lengths, bf16)
    if not x.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the fused "
                         "evidence is a CUDA kernel")
    cfg = model.cfg
    refuse_grad("fused evidence", x, tensors)
    x, lens = _prepare(model, x, u, lengths, "fused evidence", bf16)
    B, _, T = x.shape
    K = cfg.K
    # K values used in no product: the TPU wrapper computes them outside
    # its kernel too (vqvaehmm_tpu/ops/pallas_train.py:382)
    log_pi = torch.log_softmax(model.prior_module.log_prior.detach(), dim=0)
    log_obs = torch.empty((B, T, K), dtype=torch.float32, device=x.device)
    log_A = torch.empty((B, T, K, K), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return log_pi, log_A, log_obs
    plan = kernel_cache(model).plan("evidence", encoder_dims(cfg, prior=True),
                                    B, T, x.device, can_split=True, bf16=bf16)
    inert = inert_past_length and lens is not None
    _launch_evidence(model, x, u, lens, plan.tile, plan.split,
                     (log_obs, log_A), bf16, plan.weights != "direct", inert)
    with _count_lock:
        fused_evidence.launches += 1
        fused_evidence.bf16_launches += bf16
        fused_evidence.inert_launches += inert
    return log_pi, log_A, log_obs


def _launch_evidence(model, x, u, lens, tile: int, split: bool,
                     out, bf16: bool = False, staged: bool = True,
                     inert: bool = False) -> None:
    """One launch of the evidence kernel at tile width `tile`, in the
    bfloat16-operand mode where bf16 (its weights staged in shared memory
    where they fit with `staged`, else read from L2), the encoder and the
    prior in blocks of their own with `split`, into out = (log_obs,
    log_A); lens (B,) int32 contiguous or None, whose maximum the kernel
    bounds the encoder at; with `inert` the tiles that start at or past
    their row's length left inert.  It does not count: fused_evidence
    does."""
    cfg = model.cfg
    B, _, T = x.shape
    packed, bs = kernel_cache(model).weights(model, x.device, bf16=bf16)
    err = _build.library().vqhmm_fused_evidence(
        x.data_ptr(), u.data_ptr(), *_u_strides(cfg, u),
        None if lens is None else lens.data_ptr(),
        packed.data_ptr(), *[b.data_ptr() for b in bs], out[0].data_ptr(),
        out[1].data_ptr(), *_dims(cfg, B, T), tile, int(split), int(bf16),
        int(staged), int(inert),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_evidence kernel launch")


fused_evidence.launches = 0
fused_evidence.bf16_launches = 0
fused_evidence.inert_launches = 0


def decode_plan(model, B: int, T: int, device, bf16: Optional[bool] = None,
                staged: bool = True) -> DecodePlan:
    """The decode's launch plan at (B, T) in the mode (the model's on
    `device` where bf16 is None), kept a shape: the evidence plan's tile
    without the split, and the fewest tiles a block for which the blocks
    the runtime can keep resident cover every tile; in the bfloat16 mode,
    where `staged`, the second design (the evidence's weights resident in
    shared memory) where its blocks cover every tile at the first design's
    tiles a block, else the first (csrc/fused_decode.cu::
    vqhmm_fused_decode_plan, decode_choice).  Raises where no number of
    tiles a block fits a block's shared memory."""
    from .fused_train import infer_bf16_mode

    if bf16 is None:
        bf16 = infer_bf16_mode(model.cfg, device)
    cache = kernel_cache(model)
    dims = encoder_dims(model.cfg, prior=True)
    key = ("decode", bf16, staged, B, T, _build.sm_count(device))
    with cache.lock:
        plan = cache.plans.get(key)
    if plan is not None:
        return plan
    tile = cache.plan("decode", dims, B, T, device, bf16=bf16).tile
    out = (ctypes.c_int * 5)()
    lib = _build.library()
    err = lib.vqhmm_fused_decode_plan(*_dims(model.cfg, B, T), tile,
                                      int(bf16), int(staged), out)
    if err != 0:
        raise ValueError(
            f"the fused decode cannot keep the {B * -(-T // tile)} tiles of "
            f"{tile} steps at (B={B}, T={T}) resident: every tile a block "
            f"more needs {4 * tile * (model.cfg.K + model.cfg.K ** 2 + 1)} "
            f"bytes of its {SMEM_LIMIT} of shared memory (CUDA error {err})")
    plan = DecodePlan(tile, out[0], out[1], out[2], out[3],
                      WEIGHT_KINDS[out[4]])
    if plan.weights not in ("direct", "resident") or plan.smem != \
            decode_smem_bytes(model.cfg, tile, plan.ntb, bf16,
                              plan.weights == "resident"):
        raise RuntimeError("fused_decode kernel and wrapper disagree on "
                           "the shared-memory layout")
    with cache.lock:
        cache.plans[key] = plan
    return plan


def fused_viterbi_states(model, x: torch.Tensor, u: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """MAP regime path (B, T) int32 from raw x (B, C, T) and u (B, U, T) or
    (B, T, U) in one launch."""
    bf16 = operand_mode(model, x)
    tensors = evidence_tensors(model, u)
    if not kernel_route(model, x, use_kernel) or autograd_aside(
            use_kernel, x, tensors):
        return fused_viterbi_states_reference(model, x, u, lengths, bf16)
    if not x.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the fused "
                         "decode is a CUDA kernel")
    refuse_grad("fused decode", x, tensors)
    x, lens = _prepare(model, x, u, lengths, "fused decode", bf16)
    B, _, T = x.shape
    if T == 0:
        raise ValueError("Viterbi decode of an empty sequence (T=0)")
    if B == 0:
        return torch.empty((B, T), dtype=torch.int32, device=x.device)
    plan = decode_plan(model, B, T, x.device, bf16)
    states = _launch_decode(model, x, u, lens, plan, bf16)
    with _count_lock:
        fused_viterbi_states.launches += 1
        fused_viterbi_states.bf16_launches += bf16
        fused_viterbi_states.staged_launches += plan.weights == "resident"
    return states


def _launch_decode(model, x, u, lens, plan: DecodePlan,
                   bf16: bool = False) -> torch.Tensor:
    """One launch of the decode in the design of `plan` (`decode_plan`:
    the bfloat16 mode's second design where plan.weights is "resident"),
    x (B, C, T) contiguous, lens (B,) int32 or None; the states (B, T)
    int32.  It does not count: fused_viterbi_states does."""
    cfg = model.cfg
    B, _, T = x.shape
    states = torch.empty((B, T), dtype=torch.int32, device=x.device)
    packed, bs = kernel_cache(model).weights(model, x.device, bf16=bf16)
    log_pi = torch.log_softmax(model.prior_module.log_prior.detach(),
                               dim=0).contiguous()
    G, K = num_segments(T), cfg.K
    # the aggregates the blocks exchange: a segment's product and incoming
    # delta (the end delta in the last segment's product), its selector
    # map and its end state
    agg = torch.empty(B * G * (K * K + K), dtype=torch.float32,
                      device=x.device)
    words = torch.empty((2, B * G), dtype=torch.int32, device=x.device)
    err = _build.library().vqhmm_fused_decode(
        x.data_ptr(), u.data_ptr(), *_u_strides(cfg, u),
        None if lens is None else lens.data_ptr(), packed.data_ptr(),
        *[b.data_ptr() for b in bs], log_pi.data_ptr(), agg.data_ptr(),
        words[0].data_ptr(), words[1].data_ptr(), states.data_ptr(),
        *_dims(cfg, B, T), plan.tile, int(bf16),
        int(plan.weights == "resident"),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "fused_decode kernel launch")
    return states


fused_viterbi_states.launches = 0
fused_viterbi_states.bf16_launches = 0
fused_viterbi_states.staged_launches = 0
