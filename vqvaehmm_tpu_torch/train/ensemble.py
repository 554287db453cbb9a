"""Multi-seed ensemble training (counterpart of
vqvaehmm_tpu/train/ensemble.py).

N independent VAE-HMMs, one a seed, train on one shared epoch stream.
The JAX package stacks the members' TrainStates on a leading axis and
vmaps (or, fused, `lax.map`s) the update over it; here the members are a
list of TrainStates, each with its own model and ClippedAdam, updated in
turn.  On a CUDA device each member's step is one launch of the fused
train kernel (ops/fused_train.py), and the epoch is gathered once for all
members by the window-gather kernel (ops/gather.py, through
DeviceEpochSampler.epoch); on the host path it is assembled once by
data/dataset.py::epoch_arrays and uploaded once.  No member writes into
the shared epoch, and the train kernel's launch plans are keyed by widths
and shapes, so the members share them.

Member i is bit-equal to a solo run of train/trainer.py from the same
initial state over the same epochs.

`mesh=` (parallel/mesh.py) puts the member axis over the ranks, as the
JAX package's `mesh=` shards the stacked members: rank r trains members
[r N / n, (r + 1) N / n) against the whole epoch, which every rank draws
alike from the same seed, with no gradient collective; an all-gather
then collects every member's loss history, parameters and Adam moments,
so that every rank returns all N members.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.dataset import RandomChunkDataset, epoch_arrays
from ..models.vae_hmm import VAEHMM
from .trainer import (TrainState, beta_schedule, make_epoch_step,
                      make_optimizer, resolve_fused)


def init_ensemble_state(model: VAEHMM, seeds: Sequence[int], lr: float,
                        gradient_clip: Optional[float] = None,
                        device="cuda", init_states=None,
                        members: Optional[range] = None) -> List[TrainState]:
    """One TrainState a seed on `device`: member i's model has the
    parameters `VAEHMM(model.cfg)` draws from a Generator seeded with
    seeds[i] (or init_states[i], a state_dict), and its own Adam.
    members: the indices to build (default all)."""
    dev = resolve_device(device)
    states = []
    for i in members if members is not None else range(len(seeds)):
        seed = seeds[i]
        member = VAEHMM(model.cfg, device=dev, generator=torch.Generator()
                        .manual_seed(int(seed)))
        if init_states is not None:
            member.load_state_dict(init_states[i])
        states.append(TrainState(member, make_optimizer(member, lr,
                                                        gradient_clip)))
    return states


def make_ensemble_epoch_step(states: Sequence[TrainState],
                             fused: bool = False):
    """epoch(xs, us, lens, beta) -> the members' mean losses (N,), a
    device tensor: each member in turn takes every step of the shared
    epoch (stacked (batches, B, ...) tensors on the members' device)."""
    steps = [make_epoch_step(s.model, s.optimizer, fused=fused)
             for s in states]

    def epoch(xs, us, lens, beta: float) -> torch.Tensor:
        return torch.stack([step(xs, us, lens, beta) for step in steps])

    return epoch


def ensemble_member(states: Sequence[TrainState], i: int) -> TrainState:
    """Member i's TrainState."""
    return states[i]


def _member_rows(state: TrainState) -> torch.Tensor:
    """A member's parameters and Adam moments as one (3, P) tensor."""
    opt = state.optimizer
    rows = [[], [], []]
    for p in state.model.parameters():
        st = opt.state.get(p, {})
        for row, t in zip(rows, (p.detach(), st.get("exp_avg"),
                                 st.get("exp_avg_sq"))):
            row.append((t if t is not None else torch.zeros_like(p))
                       .reshape(-1))
    return torch.stack([torch.cat(r) for r in rows])


def _gather_members(mesh, local: List[TrainState], model: VAEHMM,
                    seeds, lr, gradient_clip, dev) -> List[TrainState]:
    """Every member's TrainState on every rank: the ranks' parameters and
    Adam moments all-gathered in member order, and the step count, the
    same for all, from this rank's members."""
    rows = mesh.all_gather(torch.stack([_member_rows(s) for s in local]))
    states = init_ensemble_state(model, seeds, lr, gradient_clip, dev)
    step = local[0].optimizer.state[next(local[0].model.parameters())]
    for st, r in zip(states, rows):
        params = list(st.model.parameters())
        sizes = [p.numel() for p in params]
        with torch.no_grad():
            for p, v, m, s in zip(params, *(r[k].split(sizes)
                                            for k in range(3))):
                p.copy_(v.view_as(p))
                st.optimizer.state[p] = {
                    "step": step["step"].clone(),
                    "exp_avg": m.view_as(p).clone(),
                    "exp_avg_sq": s.view_as(p).clone()}
    return states


def train_ensemble(model: VAEHMM, dataset: RandomChunkDataset,
                   seeds: Sequence[int], num_epochs: int = 10,
                   lr: float = 1e-3, batch_size: int = 64,
                   gradient_clip: Optional[float] = None,
                   beta_warmup: bool = True,
                   device_data: Optional[bool] = None,
                   fused=None, device="cuda",
                   init_states=None, mesh=None, log_fn=print
                   ) -> Tuple[List[TrainState], np.ndarray, int]:
    """Train len(seeds) models of model.cfg on `device` over one shared
    epoch stream, with train_model's schedule.

    device_data / fused: None (for fused also "auto") = auto, as
    train_model: on a CUDA device the epoch gathered on the card by one
    launch of the gather kernel, with the vectorised index draws, and each
    member's step through the fused train kernel.  device_data=False
    assembles the epochs on the host, the stream a host-fed train_model of
    the same dataset sees.  The gate takes the full batch: every member
    sees all of it.

    mesh: the members over the ranks (module docstring) on the mesh's
    device, which takes the place of `device`; len(seeds) must divide
    over the ranks, and only rank 0 logs.

    Returns (states, per-member loss history (N, epochs), the index of the
    member with the lowest final loss, the first on a tie)."""
    dev = resolve_device(device if mesh is None else mesh.device)
    members = None
    if mesh is not None:
        if len(seeds) % mesh.size:
            raise ValueError(f"{len(seeds)} members do not divide over the "
                             f"{mesh.size} ranks")
        members = range(len(seeds))[mesh.rows(len(seeds))]
        if mesh.rank != 0:
            log_fn = None
    fused = resolve_fused("auto" if fused is None else fused, model.cfg,
                          batch_size, dataset.max_len, device=dev,
                          log_fn=log_fn)
    states = init_ensemble_state(model, seeds, lr, gradient_clip, dev,
                                 init_states, members)
    step = make_ensemble_epoch_step(states, fused=fused)
    if device_data is None:
        device_data = dev.type == "cuda"
    if device_data:
        from ..data.device_sampler import DeviceEpochSampler

        sampler = DeviceEpochSampler(dataset, dev)
        num_batches = len(dataset) // batch_size

    history = []
    for ep in range(num_epochs):
        beta = beta_schedule(ep, num_epochs, beta_warmup)
        if device_data:
            xs, us, lens = sampler.epoch(batch_size, num_batches,
                                         exact_stream=False)
        else:
            xs, us, lens = (torch.from_numpy(a).to(dev) for a in
                            epoch_arrays(dataset, batch_size))
        losses = step(xs, us, lens, beta)
        if mesh is not None:
            losses = mesh.all_gather(losses)
        history.append(losses)       # (N,) on the device: no sync here
        if log_fn is not None:
            l_np = losses.cpu().numpy()
            log_fn(f"Epoch {ep + 1}/{num_epochs}, "
                   f"loss min {l_np.min():.4f} / "
                   f"median {np.median(l_np):.4f} / max {l_np.max():.4f}")
    hist = torch.stack(history, dim=1).cpu().numpy()
    best = int(hist[:, -1].argmin())
    if mesh is not None:
        states = _gather_members(mesh, states, model, seeds, lr,
                                 gradient_clip, dev)
    return states, hist, best
