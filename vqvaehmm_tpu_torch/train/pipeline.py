"""Config-driven training pipeline and its CLI:

    python -m vqvaehmm_tpu_torch.train.pipeline config.json \
        [section.key=value ...] [--device cuda|cpu]

Counterpart of vqvaehmm_tpu/train/pipeline.py: config -> seed -> VAEHMM
-> sequences (a synthetic pool when the data files are missing) -> the
epoch loop -> checkpoints.  It keeps the JAX pipeline's behaviour: the
`val_fraction` split and its validation loss, periodic checkpoints every
`save_freq` epochs, a checkpoint at the epoch boundary on SIGTERM
(`preempted`, exit code 75 from the CLI), an automatic resume that
replays the sample stream so the resumed run is the uninterrupted one
bit for bit, early stopping, and the final `vae_hmm_trained` checkpoint
with `vae_hmm_trained.npz` in the JAX package's layout.

The device is explicit (`--device`, default cuda).  On a CUDA device the
defaults train through the fused train kernel and the device input
pipeline (train/trainer.py::resolve_fused, resolve_input_pipeline).
`training.steps_per_call` bounds one jitted dispatch in the JAX package;
PyTorch dispatches each step eagerly, so it is accepted and changes
nothing.  `model.family: vqvae` trains the true-VQ family through
train/vq_pipeline.py (its own trainer and archive, `vq_stack.npz`).
`training.ensemble_seeds` trains one model a seed over one shared epoch
stream (train/ensemble.py) and keeps the best final loss as
`vae_hmm_trained`: one shot, no periodic checkpoint and no resume, as in
the JAX package.  `training.profile_dir` writes a torch.profiler trace of
one steady epoch there (utils/profiling.py).  The host input pipeline
assembles the next epoch on a thread while this one trains
(data/prefetch.py).

`TrainPipeline(cfg, use_mesh=True)` trains data-parallel over the ranks
of a `torch.distributed` group (parallel/mesh.py::create_mesh, with
`mesh.num_devices` of the config): every rank runs this pipeline, draws
the same sample stream, and trains on its share of every batch
(train/trainer.py, `mesh=`); only rank 0 writes checkpoints and logs, a
barrier comes before any read, and a run saved at one world size resumes
at another.  The SIGTERM flag and the early-stopping decision are agreed
across the ranks at each epoch boundary (an all-reduce of the max), so
that no rank stops alone while the others wait in a collective.  The CLI
has no flag for it, as the JAX CLI has none: start one process a card
with `torchrun --nproc-per-node N` on a script that builds
`TrainPipeline(cfg, use_mesh=True)`.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import signal
import sys
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.config import Config, apply_overrides, load_config
from ..core.device import resolve_device
from ..data.checkpoint import (load_checkpoint, load_metadata,
                               save_checkpoint, save_params_npz)
from ..data.dataset import RandomChunkDataset, epoch_skip
from ..data.prefetch import prefetch_epochs
from ..models.vae_hmm import VAEHMM
from ..utils.profiling import trace
from .trainer import (TrainState, beta_schedule, make_epoch_step,
                      make_optimizer, resolve_fused, resolve_input_pipeline)


def load_sequences(x_path: str, u_path: str
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Load sequence arrays from .npy/.npz/.pt/.pth."""

    def load_one(p: str) -> np.ndarray:
        if p.endswith(".npy"):
            return np.load(p)
        if p.endswith(".npz"):
            with np.load(p) as data:
                return data[data.files[0]]
        if p.endswith((".pt", ".pth")):
            return np.asarray(torch.load(p, map_location="cpu",
                                         weights_only=True))
        raise ValueError(f"Unsupported data format for {p}")

    return load_one(x_path), load_one(u_path)


@contextlib.contextmanager
def _sigterm_flag():
    """Yield a list that becomes truthy when SIGTERM arrives, restoring
    the previous handler on exit.  Outside the main thread (a CPython
    restriction) the flag is inert and SIGTERM keeps its default."""
    flag = []
    try:
        prev = signal.signal(signal.SIGTERM,
                             lambda signum, frame: flag.append(True))
    except ValueError:  # not the main thread
        yield flag
        return
    try:
        yield flag
    finally:
        signal.signal(signal.SIGTERM, prev)


class TrainPipeline:
    """End-to-end config-driven training on one device."""

    def __init__(self, cfg: Config, use_mesh: bool = False, device="cuda",
                 group=None):
        """use_mesh: data parallelism over the default process group (or
        `group`), this rank on `device` (cuda:LOCAL_RANK under torchrun
        where device is "cuda")."""
        self.cfg = cfg
        self.mesh = None
        if use_mesh:
            from ..parallel.mesh import create_mesh

            self.mesh = create_mesh(cfg.mesh.num_devices, group=group,
                                    device=device)
        self.device = resolve_device(device) if self.mesh is None \
            else self.mesh.device
        # True after train() returned early on SIGTERM: the returned state
        # is the checkpointed partial run, not a finished model
        self.preempted = False
        # the epoch mean losses of the last train() call, in full precision
        self.history = []

    def build_model(self) -> VAEHMM:
        """The configured VAEHMM on the device, its parameters drawn from
        training.seed."""
        return VAEHMM(self.cfg.model, device=self.device,
                      generator=torch.Generator().manual_seed(
                          self.cfg.training.seed))

    def load_data(self) -> RandomChunkDataset:
        d = self.cfg.data
        if os.path.exists(d.x_sequences_path):
            xs, us = load_sequences(d.x_sequences_path, d.u_sequences_path)
        else:
            # the JAX pipeline's synthetic fallback, so a run needs no data
            from ..data.synthetic import synthetic_sequences

            xs, us, _ = synthetic_sequences(
                n_sequences=8, seq_len=max(d.max_len, 100),
                input_dim=self.cfg.model.input_dim,
                u_dim=self.cfg.model.u_dim or 1, K=self.cfg.model.K,
                seed=self.cfg.training.seed)
        self._val_arrays = None
        frac = float(d.val_fraction or 0.0)
        if frac > 0.0:
            # deterministic split: the last k sequences are validation
            if len(xs) < 2:
                raise ValueError("val_fraction needs >= 2 sequences")
            k = min(max(int(round(len(xs) * frac)), 1), len(xs) - 1)
            T = min(xs.shape[2], d.max_len)
            self._val_arrays = (np.asarray(xs[-k:, :, :T], np.float32),
                                np.asarray(us[-k:, :, :T], np.float32),
                                np.full((k,), T, np.int32))
            xs, us = xs[:-k], us[:-k]
        return RandomChunkDataset(xs, us, min_len=d.min_len,
                                  max_len=d.max_len,
                                  samples_per_epoch=d.samples_per_epoch,
                                  seed=self.cfg.training.seed)

    def train(self, log_fn=print, resume: bool = True) -> TrainState:
        """Train with periodic checkpoints every `save_freq` epochs and
        an automatic resume from the latest periodic checkpoint."""
        t = self.cfg.training
        mesh = self.mesh
        if self.cfg.model.family == "vqvae":
            if mesh is not None:
                raise ValueError("use_mesh trains the VAE-HMM; the VQ "
                                 "family has no data-parallel path")
            # the true-VQ family has its own trainer and archive format;
            # the knobs it honours are documented on train_vq_stack
            from .vq_pipeline import train_vq_pipeline

            self.preempted = False
            return train_vq_pipeline(self, log_fn=log_fn, resume=resume)
        self.preempted = False
        dev = self.device
        # rank 0 alone writes files and logs
        writer = mesh is None or mesh.rank == 0
        if not writer:
            log_fn = None
        model = self.build_model()
        if mesh is not None:
            from ..parallel.mesh import replicate

            replicate(mesh, model)
        dataset = self.load_data()
        os.makedirs(t.checkpoint_dir, exist_ok=True)
        if t.ensemble_seeds:
            return self._train_ensemble(model, dataset, log_fn)
        periodic = os.path.join(t.checkpoint_dir, "vae_hmm_periodic")

        nb_total = len(dataset) // t.batch_size
        state = TrainState(model, make_optimizer(
            model, t.learning_rate, t.gradient_clip,
            schedule=t.lr_schedule, warmup_steps=int(t.warmup_steps or 0),
            total_steps=t.num_epochs * max(nb_total, 1),
            final_lr_frac=float(t.final_lr_frac or 0.0)))
        start_epoch = 0
        patience = int(t.early_stop_patience or 0)
        min_delta = float(t.early_stop_min_delta or 0.0)
        val_loss_fn = None
        if self._val_arrays is not None:
            xv, uv, lv = (torch.from_numpy(a).to(dev)
                          for a in self._val_arrays)

            def val_loss_fn():
                with torch.no_grad():
                    return float(model.compute_loss(xv, uv, lv, 1.0))
        best_loss, wait = float("inf"), 0
        if mesh is not None:
            # no rank reads what rank 0 may still be writing
            mesh.barrier()
        meta = load_metadata(periodic) if resume else None
        if meta is not None and os.path.exists(periodic + ".pt"):
            state = load_checkpoint(periodic, state)
            start_epoch = int(meta.get("epoch", 0))
            best_loss = float(meta.get("best_loss", best_loss))
            wait = int(meta.get("wait", 0))
            if log_fn:
                log_fn(f"Resumed from epoch {start_epoch} "
                       f"(step {state.step})")

        # under a mesh the kernel runs on the local batch
        world = 1 if mesh is None else mesh.size
        fused = resolve_fused(t.fused, self.cfg.model, t.batch_size // world,
                              self.cfg.data.max_len, device=dev,
                              log_fn=log_fn)
        device_input = resolve_input_pipeline(t.input_pipeline,
                                              dev) == "device"
        if log_fn and (fused or device_input):
            log_fn(f"input_pipeline={'device' if device_input else 'host'}"
                   f" fused={fused} (device={dev})")
        if device_input:
            from ..data.device_sampler import DeviceEpochSampler

            sampler = DeviceEpochSampler(dataset, dev)
            gstep = sampler.make_epoch_step(model, state.optimizer,
                                            fused=fused, mesh=mesh)
        else:
            epoch_step = make_epoch_step(model, state.optimizer, fused=fused,
                                         mesh=mesh)

        if start_epoch > 0:
            # replay the sample stream's draws of epochs [0, start_epoch),
            # so the resumed epochs see the uninterrupted run's samples
            for _ in range(start_epoch):
                if device_input:
                    sampler.sample_indices_fast(t.batch_size)
                else:
                    epoch_skip(dataset, t.batch_size)

        # trace the epoch after the first, so that first calls stay out of
        # the profile; a one-epoch run traces epoch 0
        profile_ep = (min(start_epoch + 1, t.num_epochs - 1)
                      if t.profile_dir else None)
        prefetched = None
        history = self.history = []
        with contextlib.ExitStack() as stack:
            preempted = stack.enter_context(_sigterm_flag())
            if not device_input:
                # the host assembles and uploads the next epoch on a thread
                # while this one trains, in the synchronous loop's draw
                # order (under a mesh the global epoch, of which each rank
                # trains on its columns); closed on any exit
                epochs = stack.enter_context(contextlib.closing(
                    prefetch_epochs(dataset, t.batch_size,
                                    t.num_epochs - start_epoch, device=dev)))
            for ep in range(start_epoch, t.num_epochs):
                beta = beta_schedule(ep, t.num_epochs, t.beta_warmup)
                with (trace(t.profile_dir) if ep == profile_ep
                      else contextlib.nullcontext()):
                    if device_input:
                        args = (prefetched if prefetched is not None
                                else sampler.draw_epoch(t.batch_size))
                        prefetched = None
                        mean_loss = gstep(*args, beta)
                    else:
                        mean_loss = epoch_step(*next(epochs), beta)
                    if ep == profile_ep and dev.type == "cuda":
                        # the device's work lands inside the trace
                        torch.cuda.synchronize(dev)
                if device_input and ep + 1 < t.num_epochs:
                    # the next epoch's draw and upload overlap this
                    # epoch's work on the card; the rng call order is
                    # unchanged, and a draw prefetched past a stop dies
                    # with the process's rng
                    prefetched = sampler.draw_epoch(t.batch_size)
                loss = float(mean_loss)   # the epoch's one host sync
                history.append(loss)
                if log_fn:
                    log_fn(f"Epoch {ep + 1}/{t.num_epochs}, "
                           f"Loss: {loss:.4f}")
                vloss = None
                if val_loss_fn is not None and (patience > 0
                                                or log_fn is not None):
                    vloss = val_loss_fn()
                    if log_fn:
                        log_fn(f"  ValLoss: {vloss:.4f}")
                if patience > 0:
                    metric = vloss if vloss is not None else loss
                    if metric < best_loss - min_delta:
                        best_loss, wait = metric, 0
                    else:
                        wait += 1
                if t.save_freq and (ep + 1) % t.save_freq == 0 and writer:
                    save_checkpoint(periodic, state,
                                    metadata={"epoch": ep + 1,
                                              "loss": loss,
                                              "best_loss": best_loss,
                                              "wait": wait})
                stop = patience > 0 and wait >= patience
                if mesh is not None:
                    # one rank's SIGTERM or stop is every rank's
                    preempted_now, stop = mesh.agree(bool(preempted), stop)
                    if preempted_now and not preempted:
                        preempted.append(True)
                if preempted:
                    # checkpoint this epoch boundary (the resume point a
                    # periodic save makes) and return before the process
                    # is killed; the flag tells callers the state is
                    # partial
                    self.preempted = True
                    if writer:
                        save_checkpoint(periodic, state, metadata={
                            "epoch": ep + 1, "loss": loss,
                            "best_loss": best_loss, "wait": wait,
                            "preempted": True})
                    if mesh is not None:
                        mesh.barrier()
                    if log_fn:
                        log_fn(f"SIGTERM: checkpointed epoch {ep + 1}/"
                               f"{t.num_epochs}; rerun to auto-resume")
                    return state
                if stop:
                    if log_fn:
                        log_fn(f"Early stop at epoch {ep + 1}/"
                               f"{t.num_epochs}: no improvement > "
                               f"{min_delta} for {patience} epochs "
                               f"(best {best_loss:.4f})")
                    break

        epochs_run = start_epoch + len(history)
        ckpt_path = os.path.join(t.checkpoint_dir, "vae_hmm_trained")
        if writer:
            save_checkpoint(ckpt_path, state, metadata={
                "epochs": epochs_run,
                "early_stopped": epochs_run < t.num_epochs,
                "final_loss": history[-1] if history else None})
            save_params_npz(os.path.join(t.checkpoint_dir,
                                         "vae_hmm_trained.npz"),
                            model.state_dict())
        if mesh is not None:
            mesh.barrier()
        if log_fn:
            log_fn(f"Saved checkpoint to {ckpt_path}")
        return state

    def _train_ensemble(self, model: VAEHMM, dataset: RandomChunkDataset,
                        log_fn) -> TrainState:
        """training.ensemble_seeds: one model a seed over one shared epoch
        stream (train/ensemble.py), one shot; the member with the best
        final loss is saved as vae_hmm_trained (.pt with metadata, .npz)
        and returned.  Under a mesh the members are split over the ranks
        and rank 0 writes."""
        from .ensemble import ensemble_member, train_ensemble

        t = self.cfg.training
        seeds = list(t.ensemble_seeds)
        states, hist, best = train_ensemble(
            model, dataset, seeds, num_epochs=t.num_epochs,
            lr=t.learning_rate, batch_size=t.batch_size,
            gradient_clip=t.gradient_clip,
            device_data=resolve_input_pipeline(t.input_pipeline,
                                               self.device) == "device",
            fused=t.fused, device=self.device, mesh=self.mesh,
            log_fn=log_fn)
        state = ensemble_member(states, best)
        self.history = hist[best].tolist()
        ckpt_path = os.path.join(t.checkpoint_dir, "vae_hmm_trained")
        if self.mesh is None or self.mesh.rank == 0:
            save_checkpoint(ckpt_path, state, metadata={
                "epochs": t.num_epochs,
                "ensemble_seeds": seeds,
                "best_seed": seeds[best],
                "final_loss": float(hist[best, -1]),
                "per_member_final_loss": [float(l) for l in hist[:, -1]],
            })
            save_params_npz(ckpt_path + ".npz", state.model.state_dict())
        if self.mesh is not None:
            self.mesh.barrier()
        if log_fn:
            log_fn(f"ensemble: best seed {seeds[best]} "
                   f"(loss {hist[best, -1]:.4f}) -> {ckpt_path}")
        return state


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vqvaehmm_tpu_torch.train.pipeline",
        description="Train the VAE-HMM, or the VQ family, from a config "
        "file.")
    parser.add_argument("config", help="config .json or .yaml")
    parser.add_argument("overrides", nargs="*",
                        help="section.key=value overrides")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)
    cfg = load_config(args.config)
    if args.overrides:
        cfg = apply_overrides(cfg, args.overrides)
    pipe = TrainPipeline(cfg, device=args.device)
    pipe.train()
    # EX_TEMPFAIL: a preempted run is not a finished run; rerunning resumes
    return 75 if pipe.preempted else 0


if __name__ == "__main__":
    sys.exit(main())
