"""Window gather: (sequence, start, length) triples -> padded batches.

Port of the TPU kernels vqvaehmm_tpu/ops/pallas_gather.py::
_kernel_resident and ::_kernel_dma to one hand-written CUDA kernel for
Hopper (csrc/gather.cu, whose header sets out its design and bound), one
launch an epoch.  `gather_epoch` is the wrapper for the (S, B) triples of
an epoch and returns x (S, B, C, T) and u (S, B, U, T), the contract of
data.dataset.epoch_arrays and of the JAX package's DeviceEpochSampler
epoch; `gather_windows` is its S = 1 case, x (B, C, T) and u (B, U, T).
`gather_epoch_reference` and `gather_windows_reference` are their plain
PyTorch versions.  All are bit-equal to the host collate
(data/dataset.py::collate_fn): window [st, st + ln) of sequence si, zero
at t >= ln.  `gather_epoch_chunks` gathers an epoch in chunks of whole
batches, each under EPOCH_CHUNK_BYTES, one launch a chunk.

Dispatch: `use_kernel=None` launches the kernel for CUDA tensors and takes
the plain version for CPU tensors; `use_kernel=True` on a CPU tensor
raises.  `gather_epoch.launches` counts every launch of the kernel,
`gather_windows`' too.
"""

from __future__ import annotations

import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

_count_lock = threading.Lock()


def build_pools(x_seqs: Sequence[np.ndarray], u_seqs: Sequence[np.ndarray]
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, C, Tmax) and (N, U, Tmax) float32 pools, each sequence
    zero-padded to the longest one."""
    n = len(x_seqs)
    tmax = max(int(x.shape[1]) for x in x_seqs)
    px = np.zeros((n, x_seqs[0].shape[0], tmax), np.float32)
    pu = np.zeros((n, u_seqs[0].shape[0], tmax), np.float32)
    for i, (xs, us) in enumerate(zip(x_seqs, u_seqs)):
        px[i, :, :xs.shape[1]] = xs
        pu[i, :, :us.shape[1]] = us
    return px, pu


def validate_triples(si: np.ndarray, st: np.ndarray, ln: np.ndarray,
                     seq_lens: np.ndarray, T: int) -> None:
    """Raise ValueError unless every window lies inside its sequence and
    fits T (checked on the host, before the triples go to the card)."""
    si, st, ln = (np.asarray(a, np.int64) for a in (si, st, ln))
    if si.size == 0:
        return
    if si.min() < 0 or si.max() >= len(seq_lens):
        raise ValueError(f"sequence index out of range [0, {len(seq_lens)})")
    bad = (st < 0) | (ln < 0) | (ln > T) | (st + ln > seq_lens[si])
    if bad.any():
        i = int(np.argmax(bad.ravel()))
        raise ValueError(
            f"window {i} (seq {si.ravel()[i]}, start {st.ravel()[i]}, "
            f"length {ln.ravel()[i]}) lies outside its sequence or T={T}")


# the most bytes of x and u one chunk of gather_epoch_chunks holds: 64 MiB,
# 6 batches (62.9 MB) at the probe shape (B=256, C+U=20, T=512: 10.5 MB a
# batch), the whole epoch of the published configuration (15 batches of
# 0.46 MB, 6.9 MB)
EPOCH_CHUNK_BYTES = 64 << 20


def gather_windows_reference(pool_x: torch.Tensor, pool_u: torch.Tensor,
                             si: torch.Tensor, st: torch.Tensor,
                             ln: torch.Tensor, T: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: x (B, C, T), u (B, U, T)."""
    tmax = pool_x.shape[2]
    t = torch.arange(T, device=pool_x.device)
    pos = (st.long()[:, None] + t[None, :]).clamp(max=tmax - 1)
    keep = (t[None, :] < ln.long()[:, None])[:, None, :]

    def one(pool):
        rows = pool[si.long()]                              # (B, C, Tmax)
        idx = pos[:, None, :].expand(rows.shape[0], rows.shape[1], T)
        win = torch.gather(rows, 2, idx)
        return torch.where(keep, win, torch.zeros((), dtype=win.dtype,
                                                  device=win.device))

    return one(pool_x), one(pool_u)


def gather_epoch_reference(pool_x: torch.Tensor, pool_u: torch.Tensor,
                           si: torch.Tensor, st: torch.Tensor,
                           ln: torch.Tensor, T: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of gather_epoch: the batches of gather_windows_reference
    stacked, x (S, B, C, T), u (S, B, U, T)."""
    xs, us = zip(*(gather_windows_reference(pool_x, pool_u, si[i], st[i],
                                            ln[i], T)
                   for i in range(si.shape[0])))
    return torch.stack(xs), torch.stack(us)


def gather_epoch(pool_x: torch.Tensor, pool_u: torch.Tensor,
                 si: torch.Tensor, st: torch.Tensor, ln: torch.Tensor,
                 T: int, use_kernel: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (S, B, C, T), u (S, B, U, T) for the (S, B) int32 triples (si, st,
    ln) of an epoch: one launch on the card."""
    if si.dim() != 2:
        raise ValueError(f"gather_epoch takes (S, B) triples, got "
                         f"{tuple(si.shape)}")
    if use_kernel is None:
        use_kernel = pool_x.is_cuda
    if not use_kernel:
        return gather_epoch_reference(pool_x, pool_u, si, st, ln, T)
    return _launch(pool_x, pool_u, si, st, ln, T)


gather_epoch.launches = 0


def _launch(pool_x, pool_u, si, st, ln, T):
    """Kernel D over the windows of (S, B) triples: x (S, B, C, T),
    u (S, B, U, T)."""
    if not pool_x.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors; the window "
                         "gather is a CUDA kernel")
    for name, a in (("pool_x", pool_x), ("pool_u", pool_u)):
        if a.dtype != torch.float32 or a.dim() != 3 \
                or not a.is_contiguous() or a.device != pool_x.device:
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"(N, C, Tmax) tensor on {pool_x.device}")
    N, C, tmax = pool_x.shape
    U = pool_u.shape[1]
    if pool_u.shape[0] != N or pool_u.shape[2] != tmax:
        raise ValueError(f"pool_u {tuple(pool_u.shape)} does not match "
                         f"pool_x {tuple(pool_x.shape)}")
    S, B = si.shape
    idx = []
    for name, a in (("si", si), ("st", st), ("ln", ln)):
        if a.dtype != torch.int32 or tuple(a.shape) != (S, B) \
                or a.device != pool_x.device:
            raise ValueError(f"{name} must be an ({S}, {B}) int32 tensor "
                             f"on {pool_x.device}")
        idx.append(a.contiguous())
    x = torch.empty((S, B, C, T), dtype=torch.float32, device=pool_x.device)
    u = torch.empty((S, B, U, T), dtype=torch.float32, device=pool_x.device)
    if S * B == 0 or T == 0:
        return x, u
    lib = _build.library()
    stream = torch.cuda.current_stream(pool_x.device).cuda_stream
    err = lib.vqhmm_gather(pool_x.data_ptr(), pool_u.data_ptr(),
                           *[a.data_ptr() for a in idx],
                           x.data_ptr(), u.data_ptr(),
                           N, C, U, tmax, S * B, T, stream)
    _build.check(err, "gather kernel launch")
    with _count_lock:
        gather_epoch.launches += 1
    return x, u


def gather_epoch_chunks(pool_x: torch.Tensor, pool_u: torch.Tensor,
                        si: torch.Tensor, st: torch.Tensor,
                        ln: torch.Tensor, T: int):
    """The epoch of (S, B) triples in chunks of whole batches, each chunk's
    x and u within EPOCH_CHUNK_BYTES (read at the call): yields (first
    batch, x (n, B, C, T), u (n, B, U, T)), one gather_epoch a chunk."""
    S, B = si.shape
    batch_bytes = 4 * B * (pool_x.shape[1] + pool_u.shape[1]) * T
    n = max(1, EPOCH_CHUNK_BYTES // max(1, batch_bytes))   # whole batches
    for s0 in range(0, S, n):
        x, u = gather_epoch(pool_x, pool_u, si[s0:s0 + n], st[s0:s0 + n],
                            ln[s0:s0 + n], T)
        yield s0, x, u


def gather_windows(pool_x: torch.Tensor, pool_u: torch.Tensor,
                   si: torch.Tensor, st: torch.Tensor, ln: torch.Tensor,
                   T: int, use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, C, T), u (B, U, T) for the (B,) int32 triples (si, st, ln):
    gather_epoch with S = 1."""
    if use_kernel is None:
        use_kernel = pool_x.is_cuda
    if not use_kernel:
        return gather_windows_reference(pool_x, pool_u, si, st, ln, T)
    B = si.shape[0]
    for name, a in (("si", si), ("st", st), ("ln", ln)):
        if tuple(a.shape) != (B,):
            raise ValueError(f"{name} must be a ({B},) int32 tensor")
    x, u = _launch(pool_x, pool_u, si[None], st[None], ln[None], T)
    return x[0], u[0]
