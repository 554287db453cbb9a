"""Viterbi MAP decode (path and score) in one hand-written CUDA kernel.

Port of the three TPU kernels of vqvaehmm_tpu/ops/pallas_hmm.py (the
monolithic `_viterbi_kernel` and the chunked `_viterbi_fwd_tiled_kernel`
/ `_viterbi_bwd_tiled_kernel`) to csrc/viterbi.cu, which covers every T.
`viterbi_fused` is the wrapper; `viterbi_reference` is its plain PyTorch
version, the sequential decode of ops/hmm.py.

Dispatch is that of ops/fused_infer.py: `use_kernel=None` takes the
kernel for a CUDA tensor and the plain version for a CPU tensor,
`use_kernel=True` on a CPU tensor raises, `use_kernel=False` computes the
plain version.  `viterbi_fused.launches` counts the kernel's launches.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from . import _build
from .hmm import ViterbiResult, _as_time_varying
from .hmm import viterbi as viterbi_reference

# int8 backpointers and the kernel's template instances bound K.
MAX_K = 8

_count_lock = threading.Lock()


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
    if log_A.stride(3) != 1 or log_A.stride(2) != K:
        log_A = log_A.contiguous()
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
    bp = torch.empty((B, T, K), dtype=torch.int8, device=dev)
    lib = _build.library()
    err = lib.vqhmm_viterbi(
        log_pi.data_ptr(), log_A.data_ptr(), log_A.stride(0),
        log_A.stride(1), log_obs.data_ptr(),
        None if lens is None else lens.data_ptr(), bp.data_ptr(),
        states.data_ptr(), score.data_ptr(), B, T, K,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "viterbi kernel launch")
    with _count_lock:
        viterbi_fused.launches += 1
    return ViterbiResult(states, score)


viterbi_fused.launches = 0
