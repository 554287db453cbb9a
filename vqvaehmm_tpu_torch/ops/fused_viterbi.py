"""Viterbi MAP decode (path and score) in one hand-written CUDA kernel.

Port of the three TPU kernels of vqvaehmm_tpu/ops/pallas_hmm.py (the
monolithic `_viterbi_kernel` and the chunked `_viterbi_fwd_tiled_kernel`
/ `_viterbi_bwd_tiled_kernel`) to csrc/viterbi.cu, a segmented max-plus
scan parallel in time (csrc/maxplus_scan.cuh).  `viterbi_fused` is the
wrapper and `viterbi_plan` its launch plan.  It has two plain PyTorch
versions: `viterbi_reference`, the sequential decode of ops/hmm.py (the
CPU path), and `viterbi_segmented_reference`, the kernel's scan operation
for operation, which the kernel matches bit for bit (tests and
chip_smoke.py use it; no main path does).  Against the sequential decode
the scan reassociates the sums at segment boundaries, so the scores agree
to float roundings (1e-4 absolute or 32 float32 roundings of the score)
and the states are equal or tie within that.

Dispatch is that of ops/fused_infer.py: `use_kernel=None` takes the
kernel for a CUDA tensor and the plain version for a CPU tensor,
`use_kernel=True` on a CPU tensor raises, `use_kernel=False` computes the
plain version.  `viterbi_fused.launches` counts the kernel's launches.
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import torch

from . import _build
from .fused_infer import H100_SMS, SMEM_LIMIT
from .hmm import ViterbiResult, _as_time_varying, _mask_inputs
from .hmm import viterbi as viterbi_reference

# 4-bit backpointers and the kernel's template instances bound K.
MAX_K = 8
# threads a block at most (csrc/viterbi.cu), and the plan's bound on a
# sequence's staged round of log_obs and log_A
MAX_LANES = 256
STAGE_BYTES = 163840

_count_lock = threading.Lock()


def segment_length(T: int) -> int:
    """S, the steps a segment of the scan (csrc/maxplus_scan.cuh::seg_len):
    a function of T alone, dividing 16."""
    return 16 if T > 128 else 8 if T > 32 else 4


def num_segments(T: int) -> int:
    return -(-T // segment_length(T))


def fold_chunk(G: int) -> int:
    """Segments a chunk of the two-level fold (csrc/maxplus_scan.cuh::
    fold_chunk): every segment, one serial pass, up to G = 64, else 8."""
    return 8 if G > 64 else G


class ScanPlan(NamedTuple):
    lanes: int         # threads a sequence: segments a round
    seqs: int          # sequences a block
    threads: int       # a block
    blocks: int
    smem: int          # dynamic shared memory a block, bytes


def _r4(n: int) -> int:
    return (n + 3) // 4 * 4


def viterbi_smem_bytes(T: int, K: int, stationary: bool, lanes: int,
                       seqs: int) -> int:
    """Shared memory of a block (csrc/viterbi.cu::layout): a round's staged
    obs and log_A (a word of pad after each segment's steps), products and
    incoming deltas, the fold's chunk products and chunk deltas and carried
    delta, the end delta, the reverse pass's scratch, and every segment's
    selector map (a word) and end state (a byte)."""
    S, G = segment_length(T), num_segments(T)
    chunks = lanes // 8 + 2
    words = (_r4(lanes * (S * K + 1))
             + _r4(K * K if stationary else lanes * (S * K * K + 1))
             + _r4(lanes * K * K) + _r4(lanes * K) + _r4(chunks * K * K)
             + _r4(chunks * K) + _r4(K) + _r4(K) + _r4(2 * lanes + 1)
             + _r4(G) + _r4(-(-G // 4)))
    return 4 * seqs * words


def viterbi_plan(B: int, T: int, K: int, stationary: bool,
                 sms: int = H100_SMS) -> ScanPlan:
    """A thread a segment, as many a round as a sequence's staged round of
    STAGE_BYTES holds (at most MAX_LANES, at most the segments; a multiple
    of 8 where the fold's chunks of 8 must not straddle two rounds); where
    a sequence takes at most 16 threads, up to a warp of sequences a
    block, no more than leaves a block for every SM.  Changes no bit."""
    S, G = segment_length(T), num_segments(T)
    per_step = 4 * (K + (0 if stationary else K * K))
    lanes = max(1, min(G, MAX_LANES, STAGE_BYTES // (S * per_step)))
    if lanes < G and fold_chunk(G) < G:
        lanes = lanes // 8 * 8
    seqs = max(1, min(32 // lanes, -(-B // sms))) if lanes <= 16 else 1
    return ScanPlan(lanes, seqs, -(-lanes * seqs // 32) * 32,
                    -(-B // seqs),
                    viterbi_smem_bytes(T, K, stationary, lanes, seqs))


def viterbi_segmented_reference(log_pi, log_A, log_obs,
                                lengths: Optional[torch.Tensor] = None
                                ) -> ViterbiResult:
    """The kernel's scan in plain PyTorch, its float operations in its
    order (csrc/maxplus_scan.cuh): (a) segment 0 run from delta_0 and the
    products of the segments 1..G-2 from unit vectors, (b) the fold (in
    two levels over chunks of 8 segments above G = 64),
    (c) the rerun of the segments 1..G-1 from their incoming deltas with
    backpointers and selector maps, (d) the final argmax and the reverse
    pass over the maps, (e) each segment's backtrace.  The kernel is
    bit-equal to it; tests and chip_smoke.py use it, no main path does."""
    B, T, K = log_obs.shape
    A, O = _mask_inputs(_as_time_varying(log_A, B, T), log_obs, lengths)
    S, G = segment_length(T), num_segments(T)
    dev = log_obs.device

    def step(d, t):
        # d (B, N, R, K) rows of N segments at their step t (N,)
        best, arg = torch.max(d[..., :, None] + A[:, t][:, :, None], dim=-2)
        return best + O[:, t][:, :, None, :], arg

    bp = torch.zeros((B, T, K), dtype=torch.long, device=dev)
    # (a) segment 0, seeded with delta_0
    d0 = (log_pi[None, :] + O[:, 0])[:, None, None]
    for t in range(1, min(S, T)):
        d0, arg = step(d0, torch.tensor([t], device=dev))
        bp[:, t] = arg[:, 0, 0]
    d0 = d0[:, 0, 0]
    # (a) the products of segments 1..G-2, row r from the unit vector at r
    mid = torch.arange(1, max(1, G - 1), device=dev) * S
    unit = torch.full((K, K), float("-inf"), dtype=O.dtype, device=dev)
    unit.fill_diagonal_(0.0)
    P = unit.expand(B, len(mid), K, K)
    for s in range(S):
        P = step(P, mid + s)[0]
    # (b) the fold, in chunks of C segments aligned at multiples of C: the
    # product of each chunk's P_g but the last chunk's (each row folded left
    # to right), the chunks' incoming deltas folded from them in order,
    # then each chunk's own P_g from its incoming delta
    def fold(x, m):
        return torch.max(x[..., :, None] + m, dim=-2).values

    C = fold_chunk(G)
    nc = -(-G // C)
    chunk_in = [d0]
    for c in range(nc - 1):
        first, end = max(1, c * C), min(c * C + C, G)
        Q = P[:, first - 1]
        for g in range(first + 1, end):
            Q = fold(Q, P[:, g - 1][:, None])
        chunk_in.append(fold(chunk_in[-1], Q))
    ins = []
    for c in range(nc if G > 1 else 0):
        first, end = max(1, c * C), min(c * C + C, G)
        ins.append(chunk_in[c])
        for g in range(first, end - 1):
            ins.append(fold(ins[-1], P[:, g - 1]))
    ins = ins or [d0]
    # (c) the rerun of segments 1..G-1; a segment's map starts as identity
    starts = torch.arange(1, G, device=dev) * S
    fin = d0
    sel = torch.zeros((B, G, K), dtype=torch.long, device=dev)
    if G > 1:
        d = torch.stack(ins, dim=1)[:, :, None]               # (B, G-1, 1, K)
        smap = torch.arange(K, device=dev).expand(B, G - 1, K)
        for s in range(S):
            t = starts + s
            live = t < T
            nd, arg = step(d, t.clamp(max=T - 1))
            d = torch.where(live[None, :, None, None], nd, d)
            arg = arg[:, :, 0]
            smap = torch.where(live[None, :, None],
                               torch.gather(smap, 2, arg), smap)
            bp[:, t[live]] = arg[:, live]
        sel[:, 1:] = smap
        fin = d[:, -1, 0]
    # (d) the final state and score, then each segment's end state
    score, last = torch.max(fin, dim=-1)
    ends = [last]
    for g in range(G - 1, 0, -1):
        ends.append(torch.gather(sel[:, g], 1, ends[-1][:, None])[:, 0])
    ends = torch.stack(ends[::-1], dim=1)                     # (B, G)
    # (e) each segment walks back from its end state
    states = torch.zeros((B, T), dtype=torch.long, device=dev)
    tails = torch.clamp(torch.arange(G, device=dev) * S + S, max=T) - 1
    cur = ends
    states[:, tails] = cur
    for s in range(S - 1, 0, -1):
        t = torch.arange(G, device=dev) * S + s
        live = t <= tails
        tl = t.clamp(max=T - 1)
        prev = torch.gather(bp[:, tl], 2, cur[:, :, None])[:, :, 0]
        cur = torch.where(live[None, :], prev, cur)
        states[:, (t - 1)[live]] = cur[:, live]
    return ViterbiResult(states.to(torch.int32), score)


def viterbi_fused(log_pi: torch.Tensor, log_A: torch.Tensor,
                  log_obs: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None,
                  use_kernel: Optional[bool] = None) -> ViterbiResult:
    """ViterbiResult(states (B, T) int32, score (B,) float32), with the
    masking of ops/hmm.py for ragged `lengths` and log_A as (K, K),
    (T, K, K) or (B, T, K, K)."""
    if use_kernel is None:
        use_kernel = log_obs.is_cuda
    if not use_kernel:
        return viterbi_reference(log_pi, log_A, log_obs, lengths)
    if not log_obs.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the Viterbi "
                         "decode is a CUDA kernel")
    B, T, K = log_obs.shape
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the Viterbi kernel takes 1 <= K <= {MAX_K}, "
                         f"got K={K}")
    if T == 0:
        raise ValueError("Viterbi decode of an empty sequence (T=0)")
    dev = log_obs.device
    for name, t in (("log_pi", log_pi), ("log_A", log_A),
                    ("log_obs", log_obs)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    log_A = _as_time_varying(log_A, B, T)
    if log_A.stride(3) != 1 or log_A.stride(2) != K \
            or log_A.stride(1) not in (0, K * K):
        log_A = log_A.contiguous()
    stationary = log_A.stride(1) == 0
    log_pi = log_pi.contiguous()
    log_obs = log_obs.contiguous()
    lens = None
    if lengths is not None:
        lens = lengths.to(device=dev, dtype=torch.int32).contiguous()
        if tuple(lens.shape) != (B,):
            raise ValueError(f"lengths must be ({B},), got "
                             f"{tuple(lens.shape)}")
    states = torch.empty((B, T), dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.float32, device=dev)
    if B == 0:
        return ViterbiResult(states, score)
    plan = viterbi_plan(B, T, K, stationary, _build.sm_count(dev))
    if plan.smem > SMEM_LIMIT:
        raise ValueError(
            f"the Viterbi kernel's plan at T={T}, K={K} needs {plan.smem} "
            f"bytes of shared memory a block, of at most {SMEM_LIMIT}")
    lib = _build.library()
    if lib.vqhmm_viterbi_smem_bytes(T, K, int(stationary), plan.lanes,
                                    plan.seqs) != plan.smem:
        raise RuntimeError("viterbi kernel and wrapper disagree on the "
                           "shared-memory layout")
    bp = torch.empty((B, T), dtype=torch.int32, device=dev)
    err = lib.vqhmm_viterbi(
        log_pi.data_ptr(), log_A.data_ptr(), log_A.stride(0),
        log_A.stride(1), log_obs.data_ptr(),
        None if lens is None else lens.data_ptr(), bp.data_ptr(),
        states.data_ptr(), score.data_ptr(), B, T, K, plan.lanes, plan.seqs,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "viterbi kernel launch")
    with _count_lock:
        viterbi_fused.launches += 1
    return ViterbiResult(states, score)


viterbi_fused.launches = 0
