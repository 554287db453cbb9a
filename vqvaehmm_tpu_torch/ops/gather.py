"""Window gather: (sequence, start, length) triples -> padded batches.

Port of the TPU kernels vqvaehmm_tpu/ops/pallas_gather.py::
_kernel_resident and ::_kernel_dma to one hand-written CUDA kernel for
Hopper (csrc/gather.cu, whose header sets out its design and bound).
`gather_windows` is the wrapper; `gather_windows_reference` is its plain
PyTorch version.  Both return x (B, C, T) and u (B, U, T), bit-equal to
the host collate (data/dataset.py::collate_fn): window [st, st + ln) of
sequence si, zero at t >= ln.

Dispatch: `use_kernel=None` launches the kernel for CUDA tensors and takes
the plain version for CPU tensors; `use_kernel=True` on a CPU tensor
raises.  `gather_windows.launches` counts the kernel's launches.
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


def gather_windows(pool_x: torch.Tensor, pool_u: torch.Tensor,
                   si: torch.Tensor, st: torch.Tensor, ln: torch.Tensor,
                   T: int, use_kernel: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, C, T), u (B, U, T) for the (B,) int32 triples (si, st, ln)."""
    if use_kernel is None:
        use_kernel = pool_x.is_cuda
    if not use_kernel:
        return gather_windows_reference(pool_x, pool_u, si, st, ln, T)
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
    B = si.shape[0]
    idx = []
    for name, a in (("si", si), ("st", st), ("ln", ln)):
        if a.dtype != torch.int32 or tuple(a.shape) != (B,) \
                or a.device != pool_x.device:
            raise ValueError(f"{name} must be a ({B},) int32 tensor on "
                             f"{pool_x.device}")
        idx.append(a.contiguous())
    x = torch.empty((B, C, T), dtype=torch.float32, device=pool_x.device)
    u = torch.empty((B, U, T), dtype=torch.float32, device=pool_x.device)
    if B == 0 or T == 0:
        return x, u
    lib = _build.library()
    stream = torch.cuda.current_stream(pool_x.device).cuda_stream
    err = lib.vqhmm_gather(pool_x.data_ptr(), pool_u.data_ptr(),
                           *[a.data_ptr() for a in idx],
                           x.data_ptr(), u.data_ptr(),
                           N, C, U, tmax, B, T, stream)
    _build.check(err, "gather kernel launch")
    with _count_lock:
        gather_windows.launches += 1
    return x, u


gather_windows.launches = 0
