"""The ranks' side of tests/test_torch_parallel.py: functions that
vqvaehmm_tpu_torch/parallel/dryrun.py::run_world runs on each rank of a
gloo CPU world, on inputs the test made with numpy and parameters from
the JAX package's init.  The sharded step, forward, inference and
ensemble are the dry run's own checks (parallel/dryrun.py::dryrun_checks,
a job of each world); this module holds the rest.  It imports torch and
the port only: the ranks are spawned processes and need no JAX."""

import os
import signal

from vqvaehmm_tpu_torch import ModelConfig, VAEHMM
from vqvaehmm_tpu_torch.core.config import apply_overrides, config_from_dict
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
from vqvaehmm_tpu_torch.data.dataset import RandomChunkDataset
from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences
from vqvaehmm_tpu_torch.parallel import create_mesh
from vqvaehmm_tpu_torch.parallel.dryrun import dryrun_checks  # noqa: F401
from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline
from vqvaehmm_tpu_torch.train.trainer import (Trainer, make_epoch_step,
                                              make_optimizer, train_model)

LR, CLIP = 1e-3, 1.0


def _model(widths, params):
    model = VAEHMM(ModelConfig(**widths))
    model.load_state_dict(params_from_numpy(params))
    return model


def _numpy_params(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def epochs(mesh, widths, params, epochs_xul, betas):
    """make_epoch_step(mesh=) over stacked global epochs: the epoch
    losses and the final parameters."""
    model = _model(widths, params)
    step = make_epoch_step(model, make_optimizer(model, LR, CLIP), False,
                           mesh)
    losses = [float(step(xs, us, ls, b))
              for (xs, us, ls), b in zip(epochs_xul, betas)]
    return losses, _numpy_params(model)


def dataset(seed=0):
    xs, us, _ = synthetic_sequences(4, 96, 5, 4, 3, seed=0)
    return RandomChunkDataset(xs, us, min_len=16, max_len=32,
                              samples_per_epoch=32, seed=seed)


def trainers(mesh, widths):
    """train_model(mesh=) and Trainer(mesh=): two epochs of the host
    stream, each from its seed's parameters: (histories, parameters)."""
    _, hist = train_model(VAEHMM(ModelConfig(**widths)), dataset(),
                          num_epochs=2, batch_size=8, seed=5,
                          gradient_clip=CLIP, device="cpu", mesh=mesh,
                          log_fn=None)
    trainer = Trainer(VAEHMM(ModelConfig(**widths)), seed=6, mesh=mesh)
    return hist, trainer.train(dataset(1), 2, 8, log_fn=None), \
        _numpy_params(trainer.model)


def refusals(mesh):
    """What a world of this size refuses: a mesh of another size."""
    try:
        create_mesh(mesh.size * 2, device="cpu")
    except ValueError as e:
        return str(e)
    return None


def pipeline(mesh, raw, workdir, sigterm_after):
    """TrainPipeline(use_mesh=True) in `workdir`: the uninterrupted run,
    or with rank 0 sent SIGTERM after epoch `sigterm_after` (the ranks
    agree to stop).  Returns (epoch losses, preempted, final parameters,
    the files rank 0 wrote)."""
    cfg = apply_overrides(config_from_dict(raw),
                          [f"training.checkpoint_dir={workdir}"])
    pipe = TrainPipeline(cfg, use_mesh=True, device="cpu")

    def log(msg):
        if sigterm_after and msg.startswith(f"Epoch {sigterm_after}/"):
            os.kill(os.getpid(), signal.SIGTERM)

    state = pipe.train(log_fn=log)
    return (pipe.history, pipe.preempted, _numpy_params(state.model),
            sorted(os.listdir(workdir)))


def resume(mesh, raw, workdir, ranks):
    """The first `ranks` ranks resume a run in workdir through
    TrainPipeline(use_mesh=True) on a group of their own."""
    import torch.distributed as dist

    group = dist.new_group(list(range(ranks)))
    if mesh.rank >= ranks:
        return None
    cfg = apply_overrides(config_from_dict(raw),
                          [f"training.checkpoint_dir={workdir}"])
    pipe = TrainPipeline(cfg, use_mesh=True, device="cpu", group=group)
    state = pipe.train(log_fn=None)
    return pipe.history, _numpy_params(state.model), pipe.mesh.size


def world(mesh, jobs):
    """Run each (name, function, args) of jobs on this rank, in order:
    {name: result}.  One world, many checks."""
    return {name: globals()[fn](mesh, *args) for name, fn, args in jobs}
