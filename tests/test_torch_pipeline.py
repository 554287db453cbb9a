"""The port's TrainPipeline (vqvaehmm_tpu_torch/train/pipeline.py) on the
CPU: periodic checkpoints, a SIGTERM resume bit-equal to the
uninterrupted run, the written .npz read by the JAX package, the parts
not ported, the CLI, and an import that needs no JAX."""

import json
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import inputs
from vqvaehmm_tpu_torch.core.config import apply_overrides, load_config
from vqvaehmm_tpu_torch.data.checkpoint import load_metadata
from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences
from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline, main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tiny_config(tmp_path):
    xs, us, _ = synthetic_sequences(4, 120, 5, 4, 3, seed=0)
    np.save(tmp_path / "x.npy", xs)
    np.save(tmp_path / "u.npy", us)
    cfg = {
        "model": {"input_dim": 5, "hidden_dim": 8, "K": 3, "hidden_dim2": 4,
                  "u_dim": 4, "trans_hidden": 8},
        "data": {"x_sequences_path": str(tmp_path / "x.npy"),
                 "u_sequences_path": str(tmp_path / "u.npy"),
                 "min_len": 16, "max_len": 48, "samples_per_epoch": 32},
        "training": {"epochs": 5, "lr": 1e-3, "batch_size": 8,
                     "gradient_clip": 1.0, "save_freq": 2,
                     "checkpoint_dir": str(tmp_path / "ckpt"), "seed": 1},
    }
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    return str(p), tmp_path


def _cfg(path, tmp, name, **training):
    over = [f"training.checkpoint_dir={tmp / name}"]
    over += [f"training.{k}={json.dumps(v)}" for k, v in training.items()]
    return apply_overrides(load_config(path), over)


def test_periodic_checkpoints_and_npz_for_jax(tiny_config):
    from vqvaehmm_tpu.core.config import load_config as jax_load_config
    from vqvaehmm_tpu.data.checkpoint import load_params_npz
    from vqvaehmm_tpu.models.vae_hmm import VAEHMM as JaxVAEHMM

    path, tmp = tiny_config
    pipe = TrainPipeline(load_config(path), device="cpu")
    state = pipe.train(log_fn=None)
    assert state.step == 5 * (32 // 8) and len(pipe.history) == 5
    meta = load_metadata(str(tmp / "ckpt" / "vae_hmm_periodic"))
    assert meta["epoch"] == 4             # save_freq 2: epochs 2 and 4
    assert load_metadata(str(tmp / "ckpt" / "vae_hmm_trained"))[
        "epochs"] == 5

    # the .npz loads into the JAX package and gives the same loss
    params = load_params_npz(str(tmp / "ckpt" / "vae_hmm_trained.npz"))
    jm = JaxVAEHMM(jax_load_config(path).model)
    x, u, lengths = inputs(3, 40, seed=2)
    want = float(jm.compute_loss(params, jnp.asarray(x), jnp.asarray(u),
                                 jnp.asarray(lengths), 1.0))
    with torch.no_grad():
        got = float(state.model.compute_loss(torch.from_numpy(x),
                                             torch.from_numpy(u),
                                             torch.from_numpy(lengths), 1.0))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


@pytest.mark.parametrize("input_pipeline", ["host", "device"])
def test_sigterm_checkpoints_and_resumes(tiny_config, input_pipeline):
    """SIGTERM checkpoints at the next epoch boundary; the rerun resumes
    and ends bit-equal to an uninterrupted run (with the device pipeline,
    the draw the stopped process prefetched dies with it)."""
    path, tmp = tiny_config
    cfg = _cfg(path, tmp, "sig", input_pipeline=input_pipeline)
    calls = []

    def preempt_at_2(msg):
        calls.append(msg)
        if msg.startswith("Epoch 2/"):
            os.kill(os.getpid(), signal.SIGTERM)   # handled: sets a flag

    pipe = TrainPipeline(cfg, device="cpu")
    state = pipe.train(log_fn=preempt_at_2)
    assert pipe.preempted and state.step == 2 * (32 // 8)
    meta = load_metadata(str(tmp / "sig" / "vae_hmm_periodic"))
    assert meta["epoch"] == 2 and meta["preempted"]
    assert any(m.startswith("SIGTERM") for m in calls)
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL

    pipe2 = TrainPipeline(cfg, device="cpu")
    resumed = pipe2.train(log_fn=None)
    assert not pipe2.preempted and resumed.step == 5 * (32 // 8)

    solo = TrainPipeline(_cfg(path, tmp, "solo",
                              input_pipeline=input_pipeline),
                         device="cpu").train(log_fn=None)
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            solo.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_not_ported_raise(tiny_config):
    """The device mesh, ported since, is refused where there is no
    process group to join (tests/test_torch_parallel.py trains on one);
    training.ensemble_seeds and training.profile_dir, refused before they
    were ported, now train (the best member saved with JAX's metadata
    keys) and write a trace."""
    path, tmp = tiny_config
    cfg = load_config(path)
    with pytest.raises(RuntimeError, match="no process group"):
        TrainPipeline(cfg, use_mesh=True, device="cpu")
    state = TrainPipeline(_cfg(path, tmp, "ens", ensemble_seeds=[1, 2]),
                          device="cpu").train(log_fn=None)
    assert state.step == 5 * (32 // 8)            # one member's steps
    meta = load_metadata(str(tmp / "ens" / "vae_hmm_trained"))
    assert sorted(meta) == ["best_seed", "ensemble_seeds", "epochs",
                            "final_loss", "per_member_final_loss"]
    assert meta["final_loss"] == min(meta["per_member_final_loss"])
    assert (tmp / "ens" / "vae_hmm_trained.npz").exists()
    TrainPipeline(_cfg(path, tmp, "prof", profile_dir=str(tmp / "p")),
                  device="cpu").train(log_fn=None)
    assert (tmp / "p" / "trace.json").stat().st_size > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TrainPipeline(cfg, device="cuda")


def test_cli_trains_on_cpu(tiny_config, capsys):
    path, tmp = tiny_config
    assert main([path, f"training.checkpoint_dir={tmp / 'cli'}",
                 "training.epochs=1", "training.steps_per_call=1",
                 "--device", "cpu"]) == 0
    assert (tmp / "cli" / "vae_hmm_trained.npz").exists()
    assert "Epoch 1/1" in capsys.readouterr().out


def test_training_import_needs_no_jax():
    code = ("import sys, vqvaehmm_tpu_torch.train.pipeline, "
            "vqvaehmm_tpu_torch.ops.fused_train, "
            "vqvaehmm_tpu_torch.ops.gather, "
            "vqvaehmm_tpu_torch.train.vq_pipeline, "
            "vqvaehmm_tpu_torch.serve.vq, "
            "vqvaehmm_tpu_torch.train.gmm_pipeline, "
            "vqvaehmm_tpu_torch.train.ensemble, "
            "vqvaehmm_tpu_torch.data.prefetch, "
            "vqvaehmm_tpu_torch.utils.profiling; "
            "bad = [m for m in ('jax', 'triton', 'vqvaehmm_tpu', 'pandas', "
            "'sklearn') if m in sys.modules]; print(bad); "
            "sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
