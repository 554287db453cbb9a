"""Vector quantization: nearest-code lookup, the straight-through
quantizer with its losses, and EMA codebook updates.

Counterpart of vqvaehmm_tpu/ops/vq.py.  The nearest-code step is the TPU
kernel `_vq_kernel` (entry `vq_pallas`) ported to one hand-written CUDA
kernel for Hopper (csrc/vq.cu, whose header sets out its design and
bound).  `vq_nearest` is the wrapper; `vq_nearest_reference` is its plain
PyTorch version, `nearest_codes` as the JAX module writes it:
scores = z @ E^T - 0.5 |e|^2, argmax, the first index on a tie.

Dispatch is that of ops/gather.py: `use_kernel=None` launches the kernel
for a CUDA tensor and computes the plain version for a CPU tensor;
`use_kernel=True` on a CPU tensor raises; `use_kernel=False` is the plain
version on any device.  On a CUDA tensor a shape or type that
`vq_supported` refuses raises, it never gives way to the plain version.
`vq_nearest.launches` counts the kernel's launches.

No gradient passes through the kernel, and no torch.autograd.Function is
needed for it: code indices are integers, whose cotangents are zero (the
JAX package's `_pallas_nearest_codes` returns zeros).  `quantize_st`
calls the kernel on detached tensors for the indices alone and rebuilds
z_q as `one_hot(idx) @ codebook`, as the JAX module does: the codebook
loss then reaches the codebook through a matrix product, whose backward
is deterministic on the card (the backward of an index lookup adds with
float atomics, in an order that changes from run to run).
"""

from __future__ import annotations

import threading
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# what csrc/vq.cu holds: the latents of a token in registers, the padded
# codebook and its half norms in a block's default shared memory
MAX_D = 64
SMEM_LIMIT = 48 * 1024

_count_lock = threading.Lock()


class VQResult(NamedTuple):
    quantized: torch.Tensor        # z_q, shaped like z_e (straight-through)
    indices: torch.Tensor          # int32 code ids, z_e's shape without D
    commitment_loss: torch.Tensor  # beta * ||z_e - sg(e)||^2 (mean)
    codebook_loss: torch.Tensor    # ||sg(z_e) - e||^2 (mean)


def nearest_codes(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """z (N, D), codebook (M, D) -> (N,) int32 argmin_m ||z - e_m||^2.

    ||z - e||^2 = ||z||^2 - 2 z.e + ||e||^2; the ||z||^2 term is constant
    in m and dropped, so the scores are one matrix product."""
    scores = z @ codebook.T - 0.5 * (codebook * codebook).sum(-1)
    return torch.argmax(scores, dim=-1).to(torch.int32)


def _smem_bytes(M: int, D: int) -> int:
    padded = 8
    while padded < D:
        padded *= 2
    return 4 * (M * padded + M)


def vq_supported(M: int, D: int, dtype: torch.dtype, device) -> bool:
    """Whether the CUDA kernel takes an (M, D) codebook of `dtype` on
    `device`: float32 on a CUDA device, D within the register loop and the
    padded codebook with its half norms within a block's default shared
    memory."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32
            and M >= 1 and 1 <= D <= MAX_D
            and _smem_bytes(M, D) <= SMEM_LIMIT)


def vq_nearest_reference(z: torch.Tensor, codebook: torch.Tensor,
                         channels_first: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `vq_nearest`: (z_q shaped like z, idx int32)."""
    zl = z.transpose(1, 2) if channels_first else z
    idx = nearest_codes(zl.reshape(-1, zl.shape[-1]), codebook)
    zq = codebook[idx.long()].reshape(zl.shape)
    idx = idx.reshape(zl.shape[:-1])
    return (zq.transpose(1, 2) if channels_first else zq), idx


def vq_nearest(z: torch.Tensor, codebook: torch.Tensor,
               channels_first: bool = False,
               use_kernel: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nearest code of every latent: (z_q, idx).

    channels_first=False: z (..., D) -> z_q (..., D), idx (...) int32.
    channels_first=True: z (B, D, T), the model's layout, -> z_q (B, D, T),
    idx (B, T); the kernel reads it through its strides, so no transpose
    is launched.  z_q is bit-equal to codebook[idx].  Neither output
    carries a gradient."""
    if channels_first and z.dim() != 3:
        raise ValueError(f"channels_first needs z as (B, D, T), got "
                         f"{tuple(z.shape)}")
    D = z.shape[1] if channels_first else z.shape[-1]
    if codebook.dim() != 2 or codebook.shape[1] != D:
        raise ValueError(f"codebook {tuple(codebook.shape)} does not match "
                         f"latents of width {D}")
    if use_kernel is None:
        use_kernel = z.is_cuda
    if not use_kernel:
        return vq_nearest_reference(z.detach(), codebook.detach(),
                                    channels_first)
    if not z.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the "
                         "nearest-code lookup is a CUDA kernel")
    M = codebook.shape[0]
    if codebook.device != z.device or codebook.dtype != z.dtype \
            or not vq_supported(M, D, z.dtype, z.device):
        raise ValueError(
            f"the nearest-code kernel does not take z {z.dtype} on "
            f"{z.device} with a ({M}, {D}) {codebook.dtype} codebook on "
            f"{codebook.device} (vq_supported: float32, D <= {MAX_D}, "
            f"{_smem_bytes(M, D)} bytes of shared memory against "
            f"{SMEM_LIMIT}); pass use_kernel=False for the plain version")
    z = z.detach().contiguous()
    cb = codebook.detach().contiguous()
    zq = torch.empty_like(z)
    if channels_first:
        B, _, T = z.shape
        strides = (D * T, T, 1)
        idx = torch.empty((B, T), dtype=torch.int32, device=z.device)
    else:
        B, T = 1, z.numel() // D
        strides = (0, 1, D)
        idx = torch.empty(z.shape[:-1], dtype=torch.int32, device=z.device)
    if B * T == 0:
        return zq, idx
    err = _build.library().vqhmm_vq_nearest(
        z.data_ptr(), *strides, cb.data_ptr(), zq.data_ptr(),
        idx.data_ptr(), B, T, M, D,
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(err, "nearest-code kernel launch")
    with _count_lock:
        vq_nearest.launches += 1
    return zq, idx


vq_nearest.launches = 0


def vq_lookup(z: torch.Tensor, codebook: torch.Tensor,
              use_kernel: Optional[bool] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize z (..., D): (z_q (..., D), idx (...) int32), without
    gradients (quantize_st is the differentiable surface)."""
    return vq_nearest(z, codebook, use_kernel=use_kernel)


def quantize_st(z_e: torch.Tensor, codebook: torch.Tensor,
                commitment_beta: float = 0.25,
                use_kernel: Optional[bool] = None,
                mask: Optional[torch.Tensor] = None,
                channels_first: bool = False) -> VQResult:
    """Quantize with the straight-through estimator:
    z_q_st = z_e + sg(z_q - z_e), with the commitment and codebook losses.

    z_e is (..., D), or (B, D, T) with channels_first.  mask: optional
    validity over z_e's dims without D; with it the two losses are means
    over the valid positions only, so padded steps cannot pull the
    codebook toward padding latents."""
    _, idx = vq_nearest(z_e, codebook, channels_first,
                        use_kernel=use_kernel)
    onehot = F.one_hot(idx.long(), codebook.shape[0]).to(z_e.dtype)
    z_q = onehot @ codebook                              # (..., D)
    if channels_first:
        z_q = z_q.transpose(1, 2)
    if mask is not None:
        m = mask.to(z_e.dtype).unsqueeze(1 if channels_first else -1)
        D = z_e.shape[1] if channels_first else z_e.shape[-1]
        denom = torch.clamp(m.sum() * D, min=1.0)
        commitment = commitment_beta * (
            ((z_e - z_q.detach()) ** 2) * m).sum() / denom
        codebook_loss = (((z_e.detach() - z_q) ** 2) * m).sum() / denom
    else:
        commitment = commitment_beta * ((z_e - z_q.detach()) ** 2).mean()
        codebook_loss = ((z_e.detach() - z_q) ** 2).mean()
    z_q_st = z_e + (z_q - z_e).detach()
    return VQResult(z_q_st, idx, commitment, codebook_loss)


class EMAState(NamedTuple):
    cluster_size: torch.Tensor  # (M,)
    cluster_sum: torch.Tensor   # (M, D)


def ema_init(codebook: torch.Tensor) -> EMAState:
    return EMAState(torch.ones(codebook.shape[0], dtype=codebook.dtype,
                               device=codebook.device),
                    codebook.detach().clone())


def ema_update(state: EMAState, codebook: torch.Tensor, z_e: torch.Tensor,
               idx: torch.Tensor, decay: float = 0.99, eps: float = 1e-5
               ) -> Tuple[EMAState, torch.Tensor]:
    """EMA codebook update (the VQ-VAE appendix variant): moving averages
    of each code's count and sum; returns the new (state, codebook)."""
    M = codebook.shape[0]
    flat = z_e.reshape(-1, z_e.shape[-1])
    onehot = F.one_hot(idx.reshape(-1).long(), M).to(flat.dtype)  # (N, M)
    counts = onehot.sum(0)
    sums = onehot.T @ flat
    size = decay * state.cluster_size + (1 - decay) * counts
    total = decay * state.cluster_sum + (1 - decay) * sums
    n = size.sum()
    stable = (size + eps) / (n + M * eps) * n
    return EMAState(size, total), total / stable[:, None]
