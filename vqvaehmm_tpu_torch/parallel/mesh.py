"""The data axis over processes (counterpart of
vqvaehmm_tpu/parallel/mesh.py).

The JAX package runs one controller over a `jax.sharding.Mesh` and lets
XLA insert the gradient psum.  Here each rank of the data axis is a
process of its own, one a card, in a `torch.distributed` process group
(started by `torchrun --nproc-per-node N`, or by the caller), and the
collectives are written out where the JAX package's psum, pmax and
all_gather sit:

* `create_mesh(num_devices, axis_name="data")` -> `Mesh`, this rank's
  handle on the group: its rank, the world size and its device;
* `shard_batch(mesh, tree, dim=0)`: this rank's rows of batch-leading
  tensors, rows [r B / n, (r + 1) B / n), on its device;
* `replicate(mesh, tree)`: parameters (a module or a dict of tensors)
  broadcast from rank 0 in place;
* `create_mesh_2d(n_data, n_model)` -> `Mesh2D`: the world as an
  n_data x n_model grid (rank r at row r // n_model, column r % n_model),
  a `Mesh` over this rank's column (the "data" axis: the ranks that hold
  the same members, each its rows of a batch) and one over its row (the
  "model" axis: the ranks that hold the same rows, each its members), the
  layout the JAX dry run gives the ensemble head (models/portfolio.py::
  EnsemblePortfolioOptimizer.shard_members).

The model, its parameters and the optimizer state are replicated; each
rank takes its share of every batch, and one all-reduce of the sum over
kernel C's flat gradient vector makes every rank's update the
single-device update (train/trainer.py).  torch's
DistributedDataParallel is not used: it averages gradients that here are
already globally scaled, it hooks into autograd, from which kernel C's
gradients do not come, and it has no place for the global valid_to.

The backend is the group's own: NCCL for CUDA tensors (one card a rank),
gloo for CPU tensors.  Nothing switches backends or devices on its own.
Every group this module starts has a timeout (`TIMEOUT`), so a rank that
stops answering ends the others' collectives with an error, not a hang.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..core.device import resolve_device

# a collective's longest wait before it raises
TIMEOUT = datetime.timedelta(seconds=300)


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data axis: the process group, this rank,
    the world size and the device this rank computes on."""

    group: "dist.ProcessGroup"
    rank: int
    size: int
    device: torch.device
    axis_name: str = "data"

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
        """t reduced over the ranks in place (the sum by default)."""
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' tensors of one shape, joined along dim in rank
        order."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def agree(self, *flags: bool) -> Tuple[bool, ...]:
        """Each flag True on every rank where any rank says True, in one
        all-reduce of the max: a decision one rank can make alone (a
        SIGTERM, early stopping) taken by all, so that no rank waits in a
        collective the others have left."""
        t = torch.tensor([int(bool(f)) for f in flags], dtype=torch.int32,
                         device=self.device)
        return tuple(bool(v) for v in
                     self.all_reduce_(t, dist.ReduceOp.MAX).tolist())

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def rows(self, n: int) -> slice:
        """This rank's share [r n / size, (r + 1) n / size) of n rows; n
        must divide over the ranks."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over the "
                             f"{self.size} ranks of the '{self.axis_name}' "
                             "axis")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)


def _rank_device(device) -> torch.device:
    """The device of this rank: a CUDA device without an index is the card
    LOCAL_RANK names (as torchrun sets it); None is that card where CUDA
    is there, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return resolve_device(dev)


def create_mesh(num_devices: Optional[int] = None, axis_name: str = "data",
                group: Optional["dist.ProcessGroup"] = None,
                device=None) -> Mesh:
    """This rank's Mesh over the data axis.

    group: a process group the caller started; None joins the default
    group, and where there is none yet starts it from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)
    with NCCL on a CUDA device and gloo on the CPU.  device: this rank's
    device; "cuda" without an index, or None where CUDA is there, is
    cuda:LOCAL_RANK (None is the CPU elsewhere).
    num_devices: the world size the caller expects; a world of another
    size raises, rather than quietly running a run of another width (the
    JAX package refuses a mesh larger than the devices it sees)."""
    dev = _rank_device(device)
    if group is None:
        if not dist.is_initialized():
            if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
                raise RuntimeError(
                    "create_mesh: no process group and no torchrun "
                    "environment (RANK, WORLD_SIZE, MASTER_ADDR, "
                    "MASTER_PORT); run under `torchrun --nproc-per-node N` "
                    "or pass group=")
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method="env://", timeout=TIMEOUT)
        group = dist.group.WORLD
    size = dist.get_world_size(group)
    if num_devices is not None and size != num_devices:
        raise ValueError(
            f"requested a {num_devices}-device mesh but the process group "
            f"has {size} rank(s); start one process a device "
            f"(torchrun --nproc-per-node {num_devices})")
    return Mesh(group, dist.get_rank(group), size, dev, axis_name)


@dataclass(frozen=True)
class Mesh2D:
    """One rank's view of a (data x model) grid over one world: `data`
    spans this rank's column of the grid, `model` its row."""

    data: Mesh
    model: Mesh

    @property
    def device(self) -> torch.device:
        return self.data.device


def create_mesh_2d(n_data: int, n_model: int, device=None) -> Mesh2D:
    """This rank's Mesh2D over the default process group, which must hold
    n_data * n_model ranks.  Every rank creates every row's and every
    column's group, in one order (torch.distributed requires it of
    new_group), and keeps its own two.  device: as create_mesh's."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh_2d needs a started process group")
    world = dist.get_world_size()
    if world != n_data * n_model:
        raise ValueError(f"a {n_data} x {n_model} grid needs "
                         f"{n_data * n_model} ranks; the group has {world}")
    rows = [dist.new_group([i * n_model + j for j in range(n_model)],
                           timeout=TIMEOUT) for i in range(n_data)]
    cols = [dist.new_group([i * n_model + j for i in range(n_data)],
                           timeout=TIMEOUT) for j in range(n_model)]
    i, j = divmod(dist.get_rank(), n_model)
    return Mesh2D(data=create_mesh(n_data, "data", cols[j], device),
                  model=create_mesh(n_model, "model", rows[i], device))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree, dim: int = 0):
    """This rank's rows of every batch-leading array of `tree` (a tensor
    or numpy array, or a dict, list or tuple of them), along `dim` (1 for
    stacked epochs (batches, B, ...)), as tensors on the rank's device.
    B must divide over the ranks."""
    def take(a):
        t = torch.as_tensor(a)
        return t.narrow(dim, mesh.rows(t.shape[dim]).start,
                        t.shape[dim] // mesh.size).to(mesh.device)
    return _map(tree, take)


def replicate(mesh: Mesh, tree):
    """Rank 0's values of `tree` (an nn.Module's parameters and buffers,
    or a dict, list or tuple of tensors on the rank's device) on every
    rank, in place; returns tree."""
    if isinstance(tree, torch.nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
    else:
        tensors = []
        _map(tree, tensors.append)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=dist.get_global_rank(mesh.group, 0),
                           group=mesh.group)
    return tree
