"""Host-side data pipeline: random chunk sampling and fixed-shape batching.

The numpy path of vqvaehmm_tpu/data/dataset.py, copied because that
package cannot be imported without JAX.  The same seed gives the same
sample stream as the JAX package's numpy path (use_native=False there):
RandomChunkDataset draws a random source sequence, a chunk length in
[min_len, min(max_len, seq_len)] and a start, and collate_fn zero-pads a
batch to (B, C, T), (B, U, T), (B,).

The JAX package's native C sampler (native/fastdata.c) is not ported: it
is an extension built into that package's directory, and its stream
differs from the numpy one, so `use_native=True` raises here.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


class RandomChunkDataset:
    """Random variable-length chunks from a pool of (C, T_i) sequences.
    len() == samples_per_epoch; __getitem__ ignores idx and samples."""

    def __init__(self, x_sequences, u_sequences, min_len: int = 20,
                 max_len: int = 200, samples_per_epoch: int = 1000,
                 seed: Optional[int] = None):
        self.x_seqs = [np.ascontiguousarray(x, dtype=np.float32)
                       for x in x_sequences]
        self.u_seqs = [np.ascontiguousarray(u, dtype=np.float32)
                       for u in u_sequences]
        if len(self.x_seqs) != len(self.u_seqs):
            raise ValueError("x_sequences and u_sequences must align")
        if not self.x_seqs:
            raise ValueError("sequence pool is empty")
        if min_len > max_len:
            raise ValueError(f"min_len={min_len} > max_len={max_len}")
        for i, (xs, us) in enumerate(zip(self.x_seqs, self.u_seqs)):
            if xs.shape[1] != us.shape[1]:
                raise ValueError(
                    f"sequence {i}: x/u time dims must match "
                    f"({xs.shape[1]} vs {us.shape[1]})")
            if xs.shape[1] < min_len:
                raise ValueError(
                    f"sequence {i} is shorter than min_len "
                    f"({xs.shape[1]} < {min_len})")
        self.min_len = min_len
        self.max_len = max_len
        self.samples_per_epoch = samples_per_epoch
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.samples_per_epoch

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray, int]:
        seq_idx = int(self.rng.integers(0, len(self.x_seqs)))
        x_seq = self.x_seqs[seq_idx]
        u_seq = self.u_seqs[seq_idx]
        seq_len = x_seq.shape[1]
        hi = min(self.max_len, seq_len)
        chunk_len = int(self.rng.integers(self.min_len, hi + 1))
        start = int(self.rng.integers(0, seq_len - chunk_len + 1))
        return (x_seq[:, start:start + chunk_len],
                u_seq[:, start:start + chunk_len], chunk_len)


def pick_bucket(batch_max: int, buckets: Sequence[int],
                max_len: int) -> int:
    """Smallest bucket >= batch_max, else max_len; capped at max_len."""
    for b in sorted(buckets):
        if b >= batch_max:
            return min(b, max_len)
    return max_len


def collate_fn(batch: List[Tuple[np.ndarray, np.ndarray, int]],
               pad_to: Optional[int] = None):
    """Zero-pad a list of (x:(C,L), u:(U,L), L) to (B,C,T),(B,U,T),(B,);
    T is the batch max, or pad_to."""
    lengths = np.array([item[2] for item in batch], dtype=np.int32)
    if pad_to is not None and pad_to < int(lengths.max()):
        raise ValueError(
            f"pad_to ({pad_to}) < batch max length ({int(lengths.max())})"
            " — padding must not truncate")
    T = int(pad_to) if pad_to is not None else int(lengths.max())
    B = len(batch)
    C = batch[0][0].shape[0]
    U = batch[0][1].shape[0]
    x = np.zeros((B, C, T), dtype=np.float32)
    u = np.zeros((B, U, T), dtype=np.float32)
    for i, (xi, ui, L) in enumerate(batch):
        x[i, :, :L] = xi
        u[i, :, :L] = ui
    return x, u, lengths


def batch_iterator(dataset: RandomChunkDataset, batch_size: int,
                   length_buckets: Sequence[int] = (),
                   drop_last: bool = True
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield fixed-shape (x, u, lengths) batches for one epoch."""
    items: List[Tuple[np.ndarray, np.ndarray, int]] = []
    for i in range(len(dataset)):
        items.append(dataset[i])
        if len(items) == batch_size:
            yield _pad_batch(items, dataset.max_len, length_buckets)
            items = []
    if items and not drop_last:
        yield _pad_batch(items, dataset.max_len, length_buckets)


def _pad_batch(items, max_len, buckets):
    batch_max = max(it[2] for it in items)
    pad_to = pick_bucket(batch_max, buckets, max_len) if buckets else max_len
    return collate_fn(items, pad_to=pad_to)


def _numpy_only(use_native: Optional[bool]) -> None:
    if use_native:
        raise NotImplementedError(
            "use_native=True: the native sampler (native/fastdata.c) is not "
            "ported; the port samples with the numpy stream "
            "(ROADMAP.md queue 1, the small left-outs of the training "
            "slice)")


def epoch_arrays(dataset: RandomChunkDataset, batch_size: int,
                 num_batches: Optional[int] = None,
                 use_native: Optional[bool] = None):
    """One epoch as stacked arrays (x:(N,B,C,T), u:(N,B,U,T),
    lengths:(N,B)), padded to max_len, from the numpy sample stream."""
    _numpy_only(use_native)
    if num_batches is None:
        num_batches = len(dataset) // batch_size
    if num_batches <= 0:
        raise ValueError(
            f"no batches: batch_size={batch_size} > samples_per_epoch="
            f"{len(dataset)} (the trainer would train on nothing)")
    xs, us, ls = [], [], []
    for _ in range(num_batches):
        items = [dataset[i] for i in range(batch_size)]
        x, u, l = collate_fn(items, pad_to=dataset.max_len)
        xs.append(x)
        us.append(u)
        ls.append(l)
    return np.stack(xs), np.stack(us), np.stack(ls)


def epoch_skip(dataset: RandomChunkDataset, batch_size: int,
               num_batches: Optional[int] = None,
               use_native: Optional[bool] = None) -> None:
    """Consume exactly the rng draws one epoch_arrays call makes, without
    assembling the arrays (the resume fast-forward of train/pipeline.py).
    Must stay in lockstep with epoch_arrays' draw pattern."""
    _numpy_only(use_native)
    if num_batches is None:
        num_batches = len(dataset) // batch_size
    for _ in range(num_batches):
        for i in range(batch_size):
            dataset[i]
