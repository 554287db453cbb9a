"""Device-side epoch assembly: the host draws index triples, the card
gathers the windows.

Counterpart of vqvaehmm_tpu/data/device_sampler.py:

* the sequence pool is uploaded once, zero-padded to (N, C, Tmax) and
  (N, U, Tmax), when it is first needed;
* each epoch the host draws only (seq_idx, start, length) triples, with
  the dataset's own rng and in the JAX package's call order, so a seed
  gives the same triples in both packages;
* the card gathers the epoch's windows with the window-gather kernel
  (ops/gather.py): `epoch` in one launch, `make_epoch_step` in one launch
  a chunk of whole batches under ops/gather.py::EPOCH_CHUNK_BYTES (one
  chunk at the published configuration) before that chunk's steps.

The gathered batches are bit-equal to the host path's collate
(data/dataset.py::epoch_arrays with the same draws).

Under a mesh (parallel/mesh.py) every rank draws the same triples from
the same seed, and takes its columns [r B / n, (r + 1) B / n) of each
batch: the kernel gathers only those windows, and the sample stream is
the single-device stream.

Spans (utils/profiling.py): `sampler.draw` is a draw_epoch, its children
`sampler.sample`, `sampler.check` and `sampler.upload` (whose three
blocking copies are each a `host.sync`, as the pools' two at first use
are); `train.epoch` is an epoch of make_epoch_step.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.gather import (build_pools, gather_epoch, gather_epoch_chunks,
                          gather_windows, validate_triples)
from ..utils.profiling import host_sync, span
from .dataset import RandomChunkDataset


class DeviceEpochSampler:
    """Epoch producer with a device-resident pool, gathered on the card."""

    def __init__(self, dataset: RandomChunkDataset, device):
        self.dataset = dataset
        self.device = torch.device(device)
        self.max_len = dataset.max_len
        self.min_len = dataset.min_len
        self.seq_lens = np.array([x.shape[1] for x in dataset.x_seqs],
                                 np.int32)
        self._pools: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def pools(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (N, C, Tmax) and (N, U, Tmax) pools on the device, built and
        uploaded on first use (two blocking copies)."""
        if self._pools is None:
            px, pu = build_pools(self.dataset.x_seqs, self.dataset.u_seqs)
            with host_sync(self.device):
                gx = torch.from_numpy(px).to(self.device)
            with host_sync(self.device):
                gu = torch.from_numpy(pu).to(self.device)
            self._pools = (gx, gu)
        return self._pools

    def sample_indices(self, batch_size: int,
                       num_batches: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Index triples drawn item by item in __getitem__'s order: the
        same stream as the host path for a seed."""
        ds = self.dataset
        if num_batches is None:
            num_batches = len(ds) // batch_size
        n_items = num_batches * batch_size
        seq_idx = np.empty(n_items, np.int32)
        starts = np.empty(n_items, np.int32)
        lengths = np.empty(n_items, np.int32)
        for i in range(n_items):
            si = int(ds.rng.integers(0, len(ds.x_seqs)))
            seq_len = int(self.seq_lens[si])
            hi = min(ds.max_len, seq_len)
            ln = int(ds.rng.integers(ds.min_len, hi + 1))
            st = int(ds.rng.integers(0, seq_len - ln + 1))
            seq_idx[i], starts[i], lengths[i] = si, st, ln
        shape = (num_batches, batch_size)
        return (seq_idx.reshape(shape), starts.reshape(shape),
                lengths.reshape(shape))

    def sample_indices_fast(self, batch_size: int,
                            num_batches: Optional[int] = None
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized draws, one rng call per field: the same distribution
        as sample_indices, a different stream (the training default)."""
        ds = self.dataset
        if num_batches is None:
            num_batches = len(ds) // batch_size
        n = num_batches * batch_size
        si = ds.rng.integers(0, len(ds.x_seqs), size=n)
        seq_len = self.seq_lens[si].astype(np.int64)
        hi = np.minimum(ds.max_len, seq_len)
        ln = ds.rng.integers(ds.min_len, hi + 1)
        st = ds.rng.integers(0, seq_len - ln + 1)
        shape = (num_batches, batch_size)
        return (si.astype(np.int32).reshape(shape),
                st.astype(np.int32).reshape(shape),
                ln.astype(np.int32).reshape(shape))

    def upload(self, seq_idx: np.ndarray, starts: np.ndarray,
               lengths: np.ndarray
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Check the (batches, B) triples on the host and copy them to the
        device: the only data an epoch ships.  Each of the three copies is
        from pageable host memory, so on a CUDA device each blocks the host
        until the stream has run it (and all queued before it)."""
        with span("sampler.check"):
            validate_triples(seq_idx, starts, lengths, self.seq_lens,
                             self.max_len)
        with span("sampler.upload"):
            out = []
            for a in (seq_idx, starts, lengths):
                host = torch.from_numpy(np.ascontiguousarray(a, np.int32))
                with host_sync(self.device):
                    out.append(host.to(self.device))
            return tuple(out)

    def draw_epoch(self, batch_size: int, num_batches: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The next training epoch's triples on the device (the vectorized
        draws, uploaded): the arguments of make_epoch_step's epoch."""
        with span("sampler.draw"):
            with span("sampler.sample"):
                trip = self.sample_indices_fast(batch_size, num_batches)
            return self.upload(*trip)

    def gather(self, si: torch.Tensor, st: torch.Tensor, ln: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, C, max_len), u (B, U, max_len) for one batch's triples."""
        px, pu = self.pools()
        return gather_windows(px, pu, si, st, ln, self.max_len)

    def epoch(self, batch_size: int, num_batches: Optional[int] = None,
              exact_stream: bool = True):
        """(x:(N,B,C,max_len), u:(N,B,U,max_len), lengths:(N,B)) tensors on
        the device, the contract of data.dataset.epoch_arrays, in one
        gather.  The caller holds the whole epoch, so it is not chunked
        under EPOCH_CHUNK_BYTES: chunks would only add a copy to join them.
        exact_stream=True draws the host path's stream (per-item draws);
        False the vectorized draws."""
        draw = (self.sample_indices if exact_stream
                else self.sample_indices_fast)
        si, st, ln = self.upload(*draw(batch_size, num_batches))
        px, pu = self.pools()
        x, u = gather_epoch(px, pu, si, st, ln, self.max_len)
        return x, u, ln

    def make_epoch_step(self, model, optimizer, fused: bool = False,
                        mesh=None):
        """Epoch trainer: returns epoch(seq_idx, starts, lengths, beta) ->
        mean loss (a device scalar), with the (batches, B) int32 triples
        from draw_epoch().  The epoch is gathered in chunks of whole batches
        within ops/gather.py::EPOCH_CHUNK_BYTES, one launch a chunk, each
        before its steps; a step then takes its batch from the chunk
        (train/trainer.py::train_step).  Nothing waits for the device.
        mesh: the triples are the global epoch's; this rank gathers and
        trains on its columns, each batch normalised by its global lengths
        (one host read of them an epoch, no collective)."""
        from ..ops.fused_train import global_norms
        from ..train.trainer import train_step

        cfg = model.cfg
        C_ds = self.dataset.x_seqs[0].shape[0]
        U_ds = self.dataset.u_seqs[0].shape[0]
        if (cfg.input_dim, cfg.u_dim) != (C_ds, U_ds):
            raise ValueError(
                f"model (input_dim={cfg.input_dim}, u_dim={cfg.u_dim}) does "
                f"not match the dataset's channel counts (C={C_ds}, "
                f"U={U_ds})")

        def epoch(seq_idx, starts, lengths, beta: float) -> torch.Tensor:
            with span("train.epoch"):
                norms = [None] * seq_idx.shape[0]
                if mesh is not None:
                    norms = global_norms(lengths, self.max_len)
                    cols = mesh.rows(seq_idx.shape[1])
                    seq_idx, starts, lengths = (a[:, cols].contiguous()
                                                for a in (seq_idx, starts,
                                                          lengths))
                total = torch.zeros((), dtype=torch.float32,
                                    device=self.device)
                px, pu = self.pools()
                for s0, xs, us in gather_epoch_chunks(px, pu, seq_idx,
                                                      starts, lengths,
                                                      self.max_len):
                    for i in range(xs.shape[0]):
                        total = total + train_step(
                            model, optimizer, xs[i], us[i], lengths[s0 + i],
                            beta, fused, mesh, norms[s0 + i])
                return total / seq_idx.shape[0]

        return epoch
