"""Training of the VAE-HMM: the optimizer, the step and the epoch loop.

Counterpart of vqvaehmm_tpu/train/trainer.py, in eager PyTorch:

* `make_optimizer` -> `ClippedAdam`, torch.optim.Adam (betas 0.9/0.999,
  eps 1e-8) behind optax's clip_by_global_norm, with the learning rate of
  `make_lr_schedule` read at the number of updates made so far (optax
  reads its schedule at the pre-increment count);
* `train_step`: one update, its loss and gradients from the fused
  kernel (ops/fused_train.py) or from compute_loss and autograd.  For a
  bfloat16 model (the throughput configuration) the kernel runs its
  bfloat16-operand mode, as the TPU kernel does, and on the CPU its
  plain version of that mode; compute_loss and autograd run the model's
  bfloat16 activations, as the JAX package's unfused step does;
* `make_epoch_step`: an epoch of host-assembled batches; the device
  input pipeline's epoch is data/device_sampler.py::make_epoch_step;
* `Trainer` and `train_model`, the reference's training entry points.

An epoch makes one host sync: each step's loss stays on the device, and
only the epoch mean is read back.  `"auto"` in `resolve_fused` and
`resolve_input_pipeline` means the kernel and the device pipeline on a
CUDA device and the plain path and the host pipeline on the CPU.

`mesh=` (parallel/mesh.py) is the JAX package's data parallelism: every
rank holds the model and the optimizer, takes its rows of each global
batch, computes its share of the loss and the gradients with the global
batch's normalisation (`norm`, ops/fused_train.py: the TPU kernel's
axis_name mode), and one all-reduce of the sum over the flat gradient
vector and the loss gives every rank the global update.  Clip and Adam
then run on the same global gradient on every rank, so the parameters
stay identical across ranks.  The epoch steps take the global epoch on
every rank (each rank draws the same stream from the same seed) and
compute each batch's norm from its global lengths, with no collective;
`train_step` on a bare shard agrees on it through the mesh.

Spans (utils/profiling.py): `train.epoch` (an epoch of make_epoch_step),
`train.step` (train_step), its children `train.loss_grads` (the loss and
gradients, on any path), `train.clip` and `train.adam` (ClippedAdam.update:
the clip, then the schedule and Adam's step); `host.sync` where
shard_norm reads its all-reduced norm back.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

import torch

from ..core.device import resolve_device
from ..data.dataset import RandomChunkDataset, epoch_arrays
from ..data.prefetch import prefetch_epochs
from ..ops.fused_train import (PARAM_NAMES, Norm, fused_loss_and_flat_grads,
                               fused_loss_and_grads, global_norms,
                               loss_and_grads, split_grads,
                               train_step_supported)
from ..utils.profiling import host_sync, span


def resolve_input_pipeline(value: str, device) -> str:
    """'host' or 'device': explicit values pass through, 'auto' (the
    config default) is 'device' on a CUDA device and 'host' elsewhere.
    The device is the caller's to name: nothing resolves to the CPU path
    unasked."""
    if value in ("host", "device"):
        return value
    if value not in ("auto", None):
        raise ValueError(f"unknown input_pipeline {value!r}; "
                         "expected 'auto', 'host' or 'device'")
    return "device" if torch.device(device).type == "cuda" else "host"


def resolve_fused(value, model_cfg, batch_size: int, max_len: int,
                  device, log_fn=print) -> bool:
    """Whether the fused train kernel runs, decided before training.
    False -> the plain path (compute_loss and autograd, in the model's
    compute dtype).  'auto'/None -> the kernel on a CUDA device, the plain
    path on the CPU.  True -> the kernel (on the CPU its plain version; a
    shape the gate refuses is logged there).  A bfloat16 model's kernel
    is its bfloat16-operand mode.  On a CUDA device a shape that
    train_step_supported refuses raises: the plain path runs on the card
    only when asked for with fused=False."""
    if value is False:
        return False
    if value not in (True, "auto", None):
        raise ValueError(f"unknown fused {value!r}; "
                         "expected true, false or 'auto'")
    supported = (batch_size > 0
                 and train_step_supported(model_cfg, batch_size, max_len))
    on_cuda = torch.device(device).type == "cuda"
    if not supported and on_cuda:
        raise ValueError(
            f"the fused train kernel does not take B={batch_size}, "
            f"T={max_len} for {model_cfg} (train_step_supported refused "
            "it); pass fused=False (training.fused=false) to train on the "
            "plain path")
    if value is True:
        if not supported and log_fn:
            log_fn(f"fused step unsupported at T={max_len}, "
                   f"B={batch_size}; using the plain path")
        return supported
    return on_cuda


def beta_schedule(epoch: int, num_epochs: int, warmup: bool = True) -> float:
    """KL annealing beta = min(1, 2(ep+1)/E)."""
    if not warmup:
        return 1.0
    return min(1.0, 2.0 * (epoch + 1) / num_epochs)


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    # optax.linear_schedule: count clipped to [0, steps]
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def make_lr_schedule(lr: float, schedule: str = "constant",
                     warmup_steps: int = 0,
                     total_steps: Optional[int] = None,
                     final_lr_frac: float = 0.0
                     ) -> Union[float, Callable[[int], float]]:
    """The learning rate as a function of the update count, or the plain
    float for a constant rate without warm-up.  The same schedules as the
    JAX package's make_lr_schedule (optax's constant, cosine_decay with
    alpha=final_lr_frac, linear, and the warm-up join), as plain
    functions of the step."""
    if schedule == "constant" and warmup_steps <= 0:
        return lr
    if schedule == "constant":
        def base(count):
            return lr
    elif schedule in ("cosine", "linear"):
        if not total_steps:
            raise ValueError(f"schedule={schedule!r} needs total_steps")
        decay = max(1, int(total_steps) - int(warmup_steps))
        if schedule == "cosine":
            def base(count):
                c = min(count, decay)
                cos = 0.5 * (1.0 + math.cos(math.pi * c / decay))
                return lr * ((1.0 - final_lr_frac) * cos + final_lr_frac)
        else:
            base = _linear(lr, lr * final_lr_frac, decay)
    else:
        raise ValueError(f"unknown lr schedule {schedule!r} "
                         "(constant | cosine | linear)")
    if warmup_steps <= 0:
        return base
    warm = _linear(0.0, lr, warmup_steps)

    def joined(count: int) -> float:
        return warm(count) if count < warmup_steps \
            else base(count - warmup_steps)

    return joined


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm on every
    array when norm = sqrt(sum of all squares) is not below max_norm, the
    arrays unchanged otherwise.  (torch.nn.utils.clip_grad_norm_ scales
    by max_norm / (norm + 1e-6), which is another update.)"""
    squares = torch._foreach_mul(grads, grads)
    norm = torch.sqrt(torch.stack([s.sum() for s in squares]).sum())
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one,
                                           torch.full_like(norm, max_norm)))


class ClippedAdam(torch.optim.Adam):
    """torch.optim.Adam (betas 0.9/0.999, eps 1e-8: optax.adam in exact
    arithmetic) with an optional global-norm clip before it and a
    step-indexed learning rate.  `update()` applies one update from the
    parameters' `.grad`."""

    def __init__(self, params, lr, gradient_clip: Optional[float] = None):
        self.schedule = lr if callable(lr) else None
        super().__init__(params, lr=lr(0) if callable(lr) else lr,
                         betas=(0.9, 0.999), eps=1e-8)
        self.gradient_clip = gradient_clip

    @property
    def updates(self) -> int:
        """Updates made so far (Adam's own step count, kept on the host
        and saved in state_dict, so a resumed schedule continues)."""
        for group in self.param_groups:
            for p in group["params"]:
                state = self.state.get(p)
                return int(state["step"]) if state else 0
        return 0

    def update(self) -> None:
        params = [p for g in self.param_groups for p in g["params"]
                  if p.grad is not None]
        if self.gradient_clip is not None:
            with span("train.clip"):
                clip_by_global_norm_([p.grad for p in params],
                                     self.gradient_clip)
        with span("train.adam"):
            if self.schedule is not None:
                lr = float(self.schedule(self.updates))
                for group in self.param_groups:
                    group["lr"] = lr
            self.step()


def make_optimizer(model: torch.nn.Module, lr: float,
                   gradient_clip: Optional[float] = None,
                   schedule: str = "constant", warmup_steps: int = 0,
                   total_steps: Optional[int] = None,
                   final_lr_frac: float = 0.0) -> ClippedAdam:
    """Adam over the model's parameters, with the JAX package's defaults
    (reference parity) and its schedule knobs."""
    return ClippedAdam(model.parameters(),
                       make_lr_schedule(lr, schedule, warmup_steps,
                                        total_steps, final_lr_frac),
                       gradient_clip)


@dataclass
class TrainState:
    """The model and its optimizer; `step` counts the updates made."""

    model: torch.nn.Module
    optimizer: ClippedAdam

    @property
    def step(self) -> int:
        return self.optimizer.updates


def shard_norm(mesh, lengths: torch.Tensor, T: int) -> Tuple[int, int, int]:
    """The global batch's (valid_to, mask_total, B_total) from this rank's
    shard of its lengths: all-reduces of the max and the mask total (one
    host read each, which waits for the device)."""
    import torch.distributed as dist

    vt = lengths.max().reshape(1).to(torch.int64)
    msum = lengths.to(torch.int64).clamp(0, T).sum().reshape(1)
    mesh.all_reduce_(vt, dist.ReduceOp.MAX)
    mesh.all_reduce_(msum)
    with host_sync(lengths.device):
        valid_to = int(vt.item())
    with host_sync(lengths.device):
        mask_total = int(msum.item())
    return valid_to, mask_total, lengths.shape[0] * mesh.size


def _global_loss_and_grads(model, x, u, lengths, beta, fused: bool, mesh,
                           norm: Norm):
    """This rank's share of the global batch's loss and gradients, summed
    over the ranks by one all-reduce of [flat gradients, loss]."""
    if fused:
        loss, flat = fused_loss_and_flat_grads(model, x, u, lengths, beta,
                                               norm=norm)
    else:
        loss, grads = loss_and_grads(model, x, u, lengths, beta, norm=norm)
        flat = torch.cat([grads[n].reshape(-1) for n in PARAM_NAMES])
    buf = mesh.all_reduce_(torch.cat([flat, loss.reshape(1)]))
    return buf[-1], split_grads(dict(model.named_parameters()), buf[:-1])


def train_step(model, optimizer: ClippedAdam, x: torch.Tensor,
               u: torch.Tensor, lengths: torch.Tensor, beta: float,
               fused: bool = False, mesh=None,
               norm: Norm = None) -> torch.Tensor:
    """One update; returns the loss (a device scalar, not synchronised).
    fused=True takes the loss and all gradients from
    ops/fused_train.py (one kernel call on the card, its plain version on
    the CPU); fused=False from compute_loss and autograd.  With a mesh,
    (x, u, lengths) are this rank's rows of a global batch, and the update
    and the loss returned are the global batch's on every rank; norm, the
    global batch's normalisation, is agreed through the mesh where not
    given (module docstring)."""
    with span("train.step"):
        if mesh is not None and norm is None:
            norm = shard_norm(mesh, lengths, x.shape[-1])
        with span("train.loss_grads"):
            if mesh is None:
                loss, grads = (fused_loss_and_grads if fused
                               else loss_and_grads)(model, x, u, lengths,
                                                    beta)
            else:
                loss, grads = _global_loss_and_grads(
                    model, x, u, lengths, beta, fused, mesh, norm)
        for name, p in model.named_parameters():
            p.grad = grads[name]
        optimizer.update()
        return loss


def make_epoch_step(model, optimizer: ClippedAdam, fused: bool = False,
                    mesh=None):
    """epoch(xs, us, lens, beta) -> mean loss (a device scalar) over the
    stacked host-assembled batches (batches, B, ...), on the model's
    device.  With a mesh the arrays are the global epoch, the same on every
    rank; each rank uploads and trains on its columns of each batch."""
    dev = model.device

    def epoch(xs, us, lens, beta: float) -> torch.Tensor:
        with span("train.epoch"):
            norms = [None] * len(lens)
            if mesh is not None:
                norms = global_norms(lens, xs.shape[-1])
                xs, us, lens = (a[:, mesh.rows(a.shape[1])]
                                for a in (xs, us, lens))
            xs, us, lens = (torch.as_tensor(a).to(dev)
                            for a in (xs, us, lens))
            total = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(xs.shape[0]):
                total = total + train_step(model, optimizer, xs[i], us[i],
                                           lens[i], beta, fused, mesh,
                                           norms[i])
            return total / xs.shape[0]

    return epoch


def _replicated(model, mesh):
    """The model on the mesh's device with rank 0's parameters (each rank
    draws the same ones from a seed; the broadcast makes it so whatever
    the caller drew)."""
    if mesh is not None:
        from ..parallel.mesh import replicate

        replicate(mesh, model.to(mesh.device))
    return model


class Trainer:
    """Object-style trainer (the reference Trainer API: train_epoch /
    train, grad clip 1.0, beta warm-up flag).  The model's parameters are
    drawn from `seed` here, as the JAX Trainer draws them.  mesh: data
    parallelism, each epoch the same draws on every rank (module
    docstring)."""

    def __init__(self, model, lr: float = 1e-3,
                 gradient_clip: Optional[float] = 1.0,
                 beta_warmup: bool = True, seed: int = 0,
                 fused: bool = False, device_data: Optional[bool] = None,
                 mesh=None):
        self.model = model
        model.reset_parameters(torch.Generator().manual_seed(seed))
        _replicated(model, mesh)
        self.state = TrainState(model, make_optimizer(model, lr,
                                                      gradient_clip))
        self.beta_warmup = beta_warmup
        self._fused = fused
        self._device_data = device_data
        self._mesh = mesh
        self._epoch_step = make_epoch_step(model, self.state.optimizer,
                                           fused, mesh)
        self._sampler = None

    def train_epoch(self, dataset: RandomChunkDataset, batch_size: int,
                    beta: float = 1.0) -> float:
        device_data = self._device_data
        if device_data is None:
            device_data = self.model.device.type == "cuda"
        if device_data:
            from ..data.device_sampler import DeviceEpochSampler

            if self._sampler is None or self._sampler.dataset is not dataset:
                self._sampler = DeviceEpochSampler(dataset,
                                                   self.model.device)
                self._gstep = self._sampler.make_epoch_step(
                    self.model, self.state.optimizer, fused=self._fused,
                    mesh=self._mesh)
            return float(self._gstep(*self._sampler.draw_epoch(batch_size),
                                     beta))
        xs, us, lens = epoch_arrays(dataset, batch_size)
        return float(self._epoch_step(xs, us, lens, beta))

    def train(self, dataset: RandomChunkDataset, num_epochs: int,
              batch_size: int = 64, log_fn=print) -> list:
        history = []
        for ep in range(num_epochs):
            beta = beta_schedule(ep, num_epochs, self.beta_warmup)
            loss = self.train_epoch(dataset, batch_size, beta)
            history.append(loss)
            if log_fn:
                log_fn(f"Epoch {ep + 1}/{num_epochs}, Loss: {loss:.4f}")
        return history


def train_model(model, dataset: RandomChunkDataset, num_epochs: int = 10,
                lr: float = 1e-3, batch_size: int = 64, seed: int = 0,
                gradient_clip: Optional[float] = None,
                beta_warmup: bool = True,
                state: Optional[TrainState] = None,
                fused: Optional[bool] = None,
                device_data: Optional[bool] = None,
                device="cuda", mesh=None,
                log_fn=print) -> Tuple[TrainState, list]:
    """End-to-end training with the reference's schedule on `device`
    (which must be usable: a CUDA device without a GPU raises).  Without
    `state`, the model's parameters are drawn from `seed` and a fresh
    optimizer made.  fused / device_data: None = auto (the kernel and the
    device input pipeline on a CUDA device).  mesh: data parallelism on
    the mesh's device, which takes the place of `device` (module
    docstring); the kernel's gate takes the local batch, batch_size /
    world, and only rank 0 logs.  Returns the state and the per-epoch mean
    losses."""
    dev = resolve_device(device if mesh is None else mesh.device)
    model.to(dev)
    if state is None:
        model.reset_parameters(torch.Generator().manual_seed(seed))
        _replicated(model, mesh)
        state = TrainState(model, make_optimizer(model, lr, gradient_clip))
    if device_data is None:
        device_data = dev.type == "cuda"
    if mesh is not None and mesh.rank != 0:
        log_fn = None
    world = 1 if mesh is None else mesh.size
    fused = resolve_fused("auto" if fused is None else fused, model.cfg,
                          batch_size // world, dataset.max_len, device=dev,
                          log_fn=log_fn)
    history = []
    if device_data:
        from ..data.device_sampler import DeviceEpochSampler

        sampler = DeviceEpochSampler(dataset, dev)
        step = sampler.make_epoch_step(model, state.optimizer, fused=fused,
                                       mesh=mesh)
        epochs = (sampler.draw_epoch(batch_size) for _ in range(num_epochs))
    else:
        step = make_epoch_step(model, state.optimizer, fused, mesh)
        # the next epoch is assembled and uploaded while this one trains
        # (under a mesh the global epoch; each rank trains on its columns)
        epochs = prefetch_epochs(dataset, batch_size, num_epochs, device=dev)
    for ep, args in enumerate(epochs):
        beta = beta_schedule(ep, num_epochs, beta_warmup)
        mean_loss = step(*args, beta)
        loss = float(mean_loss)
        history.append(loss)
        if log_fn is not None:
            log_fn(f"Epoch {ep + 1}/{num_epochs}, Loss: {loss:.4f}")
    return state, history
