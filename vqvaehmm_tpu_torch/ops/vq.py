"""Vector quantization: nearest-code lookup, the straight-through
quantizer with its losses, and EMA codebook updates.

Counterpart of vqvaehmm_tpu/ops/vq.py.  The TPU kernel `_vq_kernel` (entry
`vq_pallas`) and the graph JAX's `quantize_st` builds around it are three
hand-written CUDA kernels for Hopper in csrc/vq.cu (whose header sets out
their design and bound), all on one nearest-code body:

* `vq_nearest`: the nearest code alone, (z_q, idx), for `codes`, the
  code-HMM fit, serving and the panel passes.  Its plain version is
  `vq_nearest_reference`, `nearest_codes` as the JAX module writes it:
  scores = z @ E^T - 0.5 |e|^2, argmax, the first index on a tie.
* `quantize_st_fused_forward`: idx, z_q_st = z_e + (z_q - z_e) and the
  commitment and codebook losses in one launch; plain version
  `quantize_st_forward_reference`.
* `quantize_st_fused_backward`: dz_e and dcodebook from the cotangents of
  (z_q_st, commitment, codebook_loss) in one launch; plain version
  `quantize_st_backward_reference`.

`quantize_st` sends a CUDA tensor through `_FusedQuantize`, the
torch.autograd.Function over the two quantizer kernels, and a CPU tensor
(or `use_kernel=False`) through `quantize_st_reference`, the autograd path
of one-hot products and elementwise ops that the JAX module writes.  The
kernels sum across blocks in a fixed order, with no float atomics, so VQ
training on the card repeats bit for bit from a seed.

Dispatch is that of ops/gather.py: `use_kernel=None` launches the kernel
for a CUDA tensor and computes the plain version for a CPU tensor;
`use_kernel=True` on a CPU tensor raises; `use_kernel=False` is the plain
version on any device.  On a CUDA tensor a shape or type that
`vq_supported` refuses raises, it never gives way to the plain version.
`vq_nearest.launches`, `quantize_st_fused_forward.launches` and
`quantize_st_fused_backward.launches` count the kernels' launches.
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

# what csrc/vq.cu holds: the latents of a token in registers, the padded
# codebook and its half norms in a block's default shared memory (the
# nearest-code kernel), or in up to SMEM_OPTIN with the partials of the
# quantizer's kernels
MAX_D = 64
SMEM_LIMIT = 48 * 1024
SMEM_OPTIN = 227 * 1024
THREADS = 256
TILE_FLOATS = 4096     # a backward chunk's (z - e) * m, tokens x D

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


def _padded(D: int) -> int:
    padded = 8
    while padded < D:
        padded *= 2
    return padded


def _smem_bytes(M: int, D: int) -> int:
    return 4 * (M * _padded(D) + M)


@functools.lru_cache(maxsize=None)
def quantize_smem_bytes(M: int, D: int) -> Tuple[int, int]:
    """Shared memory a block of the quantizer's forward and backward
    kernels takes (csrc/vq.cu::forward_smem, backward_smem): the forward's
    padded codebook, half norms and per-thread loss sums; the backward's
    M x D per-code sums and a chunk of tok tokens' (z - e) * m and codes."""
    tok = THREADS
    while tok > 1 and tok * D > TILE_FLOATS:
        tok //= 2
    return (_smem_bytes(M, D) + 4 * 2 * THREADS,
            4 * (M * D + D * (tok + 1) + tok))


def vq_supported(M: int, D: int, dtype: torch.dtype, device,
                 quantize: bool = False) -> bool:
    """Whether the CUDA kernels take an (M, D) codebook of `dtype` on
    `device`: float32 on a CUDA device, D within the register loop and the
    padded codebook with its half norms within a block's default shared
    memory (the nearest-code kernel) or, with `quantize`, the quantizer's
    codebook and partials within the shared memory a block can opt into."""
    if not (torch.device(device).type == "cuda" and dtype == torch.float32
            and M >= 1 and 1 <= D <= MAX_D):
        return False
    if quantize:
        return max(quantize_smem_bytes(M, D)) <= SMEM_OPTIN
    return _smem_bytes(M, D) <= SMEM_LIMIT


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


def quantize_st_reference(z_e: torch.Tensor, codebook: torch.Tensor,
                          commitment_beta: float = 0.25,
                          mask: Optional[torch.Tensor] = None,
                          channels_first: bool = False) -> VQResult:
    """Plain version of the quantizer: the JAX module's quantize_st through
    autograd (nearest codes, z_q = one_hot(idx) @ codebook, the masked
    means and the straight-through sum as separate PyTorch ops)."""
    _, idx = vq_nearest_reference(z_e.detach(), codebook.detach(),
                                  channels_first)
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


def quantize_st_forward_reference(z_e, codebook, commitment_beta=0.25,
                                  mask=None, channels_first=False):
    """Plain version of `quantize_st_fused_forward`: (z_q_st, idx,
    commitment, codebook_loss, denom), without gradients."""
    with torch.no_grad():
        r = quantize_st_reference(z_e, codebook, commitment_beta, mask,
                                  channels_first)
        # the losses' denominator: max(sum(m) * D, 1), or the latents' count
        D = z_e.shape[1] if channels_first else z_e.shape[-1]
        if mask is None:
            denom = torch.full((1,), float(z_e.numel()), dtype=z_e.dtype,
                               device=z_e.device)
        else:
            denom = torch.clamp(mask.to(z_e.dtype).sum() * D,
                                min=1.0).reshape(1)
        return (*r, denom)


def quantize_st_backward_reference(g_st, g_commit, g_cb, z_e, codebook,
                                   idx, mask, denom, commitment_beta=0.25,
                                   channels_first=False):
    """Plain version of `quantize_st_fused_backward`: (dz_e, dcodebook)
    for the cotangents of (z_q_st, commitment, codebook_loss), in the
    kernel's order of operations, each one PyTorch op:
        v         = (z_e - codebook[idx]) * m
        dz_e      = g_st + v * ((g_commit * 2 beta) / denom)
        dcodebook = (one_hot(idx)^T @ v) * ((g_cb * -2) / denom)
    dz_e is bit-equal to the kernel's; dcodebook sums in another order."""
    with torch.no_grad():
        zl = z_e.transpose(1, 2) if channels_first else z_e
        gl = g_st.transpose(1, 2) if channels_first else g_st
        M, D = codebook.shape
        v = zl - codebook[idx.long()]
        if mask is not None:
            v = v * mask.to(z_e.dtype).unsqueeze(-1)
        c_commit = g_commit * (2.0 * commitment_beta) / denom
        c_cb = g_cb * -2.0 / denom
        dz = gl + v * c_commit
        onehot = F.one_hot(idx.reshape(-1).long(), M).to(z_e.dtype)
        dcb = (onehot.T @ v.reshape(-1, D)) * c_cb
        return (dz.transpose(1, 2) if channels_first else dz), dcb


def _tokens(z: torch.Tensor, channels_first: bool):
    """(B, T, (zb, zd, zt)) of contiguous latents in the kernels' (B, D, T)
    addressing; (..., D) goes in as B=1, T=N."""
    D = z.shape[1] if channels_first else z.shape[-1]
    if channels_first:
        B, _, T = z.shape
        return B, T, (D * T, T, 1)
    return 1, z.numel() // D, (0, 1, D)


def _strides(a: torch.Tensor, channels_first: bool):
    """(a, its (B, D, T) strides) for a tensor shaped like the latents."""
    if channels_first:
        return a, tuple(a.stride())
    a = a.reshape(-1, a.shape[-1])
    return a, (0, a.stride(1), a.stride(0))


def _mask_arg(mask: Optional[torch.Tensor], z: torch.Tensor,
              channels_first: bool):
    """(mask tensor or None, mode 0/1/2 = none/bool/float32, mb, mt)."""
    if mask is None:
        return None, 0, 0, 0
    lead = ((z.shape[0], z.shape[2]) if channels_first
            else tuple(z.shape[:-1]))
    if mask.device != z.device or tuple(mask.shape) != lead:
        raise ValueError(f"the quantizer kernels take a mask of the "
                         f"latents' shape without D, {lead} on {z.device}; "
                         f"got {tuple(mask.shape)} on {mask.device}")
    m = mask
    if m.dtype not in (torch.bool, torch.float32):
        m = m.to(torch.float32)
    mode = 1 if m.dtype == torch.bool else 2
    if channels_first:
        return m, mode, m.stride(0), m.stride(1)
    m = m.reshape(-1)
    return m, mode, 0, m.stride(0)


def _check_quantize(z_e: torch.Tensor, codebook: torch.Tensor,
                    channels_first: bool) -> None:
    if channels_first and z_e.dim() != 3:
        raise ValueError(f"channels_first needs z as (B, D, T), got "
                         f"{tuple(z_e.shape)}")
    D = z_e.shape[1] if channels_first else z_e.shape[-1]
    if codebook.dim() != 2 or codebook.shape[1] != D:
        raise ValueError(f"codebook {tuple(codebook.shape)} does not match "
                         f"latents of width {D}")
    if not z_e.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the "
                         "quantizer is a CUDA kernel")
    M = codebook.shape[0]
    if codebook.device != z_e.device or codebook.dtype != z_e.dtype \
            or not vq_supported(M, D, z_e.dtype, z_e.device, quantize=True):
        raise ValueError(
            f"the quantizer kernels do not take z {z_e.dtype} on "
            f"{z_e.device} with a ({M}, {D}) {codebook.dtype} codebook on "
            f"{codebook.device} (vq_supported: float32, D <= {MAX_D}, "
            f"{max(quantize_smem_bytes(M, D))} bytes of shared memory "
            f"against {SMEM_OPTIN}); pass use_kernel=False for the plain "
            "version")


_counters: dict = {}


def _counter(device: torch.device) -> torch.Tensor:
    """The arrival counter of the kernels' last-block reduction on the
    current stream of `device`: zero between launches (the last block sets
    it back), one a stream so that streams cannot share one."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    with _count_lock:
        c = _counters.get(key)
        if c is None:
            c = _counters[key] = torch.zeros(1, dtype=torch.int32,
                                             device=device)
        return c


@functools.lru_cache(maxsize=256)
def _grids(B: int, T: int, M: int, D: int) -> Tuple[int, int]:
    """Blocks of the quantizer's forward and backward grids
    (csrc/vq.cu::vqhmm_vq_quantize_sizes)."""
    lib = _build.library()
    blocks = (lib.vqhmm_vq_quantize_sizes(B, T, M, D, 0),
              lib.vqhmm_vq_quantize_sizes(B, T, M, D, 1))
    if min(blocks) <= 0:
        raise ValueError(f"the quantizer refuses B={B}, T={T}, M={M}, D={D}")
    return blocks


def quantize_st_fused_forward(z_e: torch.Tensor, codebook: torch.Tensor,
                              commitment_beta: float = 0.25,
                              mask: Optional[torch.Tensor] = None,
                              channels_first: bool = False):
    """The quantizer's forward kernel: (z_q_st, idx, commitment,
    codebook_loss, denom) in one launch, without gradients.  idx and
    z_q_st equal the plain version's bit for bit where the two find the
    same code (they may part only at a tie to float32 rounding); the
    losses sum in another order."""
    _check_quantize(z_e, codebook, channels_first)
    return _forward(z_e, codebook, commitment_beta, mask, channels_first)


def _forward(z_e, codebook, commitment_beta, mask, channels_first):
    """quantize_st_fused_forward on arguments already checked."""
    z = z_e.detach().contiguous()
    cb = codebook.detach().contiguous()
    M, D = cb.shape
    B, T, zs = _tokens(z, channels_first)
    m, mode, mb, mt = _mask_arg(mask, z, channels_first)
    blocks = _grids(B, T, M, D)[0]
    zst = torch.empty_like(z)
    idx = torch.empty((B, T) if channels_first else z.shape[:-1],
                      dtype=torch.int32, device=z.device)
    partials = torch.empty(2 * blocks + 1, dtype=torch.float32,
                           device=z.device)
    commitment = torch.empty((), dtype=torch.float32, device=z.device)
    codebook_loss = torch.empty((), dtype=torch.float32, device=z.device)
    err = _build.library().vqhmm_vq_quantize_forward(
        z.data_ptr(), *zs, None if m is None else m.data_ptr(), mode, mb,
        mt, cb.data_ptr(), float(commitment_beta), zst.data_ptr(),
        idx.data_ptr(), partials.data_ptr(), commitment.data_ptr(),
        codebook_loss.data_ptr(), _counter(z.device).data_ptr(), B, T, M, D,
        torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(err, "quantizer forward kernel launch")
    with _count_lock:
        quantize_st_fused_forward.launches += 1
    return zst, idx, commitment, codebook_loss, partials[2 * blocks:]


quantize_st_fused_forward.launches = 0


def quantize_st_fused_backward(g_st, g_commit, g_cb, z_e, codebook, idx,
                               mask, denom, commitment_beta=0.25,
                               channels_first=False):
    """The quantizer's backward kernel: (dz_e, dcodebook) in one launch.
    dz_e is bit-equal to `quantize_st_backward_reference`; dcodebook sums
    over the tokens in a fixed order of its own, the same every call."""
    _check_quantize(z_e, codebook, channels_first)
    return _backward(g_st, g_commit, g_cb, z_e, codebook, idx, mask, denom,
                     commitment_beta, channels_first)


def _backward(g_st, g_commit, g_cb, z_e, codebook, idx, mask, denom,
              commitment_beta, channels_first):
    """quantize_st_fused_backward on arguments already checked."""
    z = z_e.detach().contiguous()
    cb = codebook.detach().contiguous()
    M, D = cb.shape
    B, T, zs = _tokens(z, channels_first)
    g, gs = _strides(g_st.to(torch.float32), channels_first)
    m, mode, mb, mt = _mask_arg(mask, z, channels_first)
    scalars = [a.to(device=z.device, dtype=torch.float32).contiguous()
               for a in (g_commit, g_cb, denom)]
    blocks = _grids(B, T, M, D)[1]
    dz = torch.empty_like(z)
    dcb = torch.empty_like(cb)
    partials = torch.empty(blocks * M * D, dtype=torch.float32,
                           device=z.device)
    err = _build.library().vqhmm_vq_quantize_backward(
        g.data_ptr(), *gs, scalars[0].data_ptr(), scalars[1].data_ptr(),
        z.data_ptr(), *zs, None if m is None else m.data_ptr(), mode, mb,
        mt, cb.data_ptr(), idx.contiguous().data_ptr(),
        scalars[2].data_ptr(), float(2.0 * commitment_beta), dz.data_ptr(),
        dcb.data_ptr(), partials.data_ptr(), _counter(z.device).data_ptr(),
        B, T, M, D, torch.cuda.current_stream(z.device).cuda_stream)
    _build.check(err, "quantizer backward kernel launch")
    with _count_lock:
        quantize_st_fused_backward.launches += 1
    return dz, dcb


quantize_st_fused_backward.launches = 0


class _FusedQuantize(torch.autograd.Function):
    """The straight-through quantizer as one forward and one backward:
    forward_fn(z_e, codebook, beta, mask, channels_first) -> (z_q_st, idx,
    commitment, codebook_loss, denom) and backward_fn(g_st, g_commit, g_cb,
    z_e, codebook, idx, mask, denom, beta, channels_first) -> (dz_e,
    dcodebook): the kernels on the card, or their plain versions.  z_q_st
    and the commitment loss carry gradients to z_e alone, the codebook loss
    to the codebook alone; idx carries none."""

    @staticmethod
    def forward(ctx, z_e, codebook, mask, beta, channels_first, forward_fn,
                backward_fn):
        z_q_st, idx, commitment, codebook_loss, denom = forward_fn(
            z_e, codebook, beta, mask, channels_first)
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(z_e, codebook, idx, mask, denom)
        ctx.beta, ctx.channels_first = beta, channels_first
        ctx.backward_fn = backward_fn
        return z_q_st, idx, commitment, codebook_loss

    @staticmethod
    def backward(ctx, g_st, _g_idx, g_commit, g_cb):
        z_e, codebook, idx, mask, denom = ctx.saved_tensors
        dz, dcb = ctx.backward_fn(g_st, g_commit, g_cb, z_e, codebook, idx,
                                  mask, denom, ctx.beta, ctx.channels_first)
        return (dz if ctx.needs_input_grad[0] else None,
                dcb if ctx.needs_input_grad[1] else None,
                None, None, None, None, None)


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
    codebook toward padding latents.  On a CUDA tensor the forward and the
    backward are one kernel launch each."""
    if use_kernel is None:
        use_kernel = z_e.is_cuda
    if not use_kernel:
        return quantize_st_reference(z_e, codebook, commitment_beta, mask,
                                     channels_first)
    _check_quantize(z_e, codebook, channels_first)
    return VQResult(*_FusedQuantize.apply(
        z_e, codebook, mask, float(commitment_beta), channels_first,
        _forward, _backward))


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
