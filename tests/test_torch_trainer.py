"""The port's trainer (vqvaehmm_tpu_torch/train/trainer.py) against the JAX
package's: a 24-step trajectory (8 epochs x 3 batches, global-norm clip
1.0, beta schedule) from one numpy parameter set, every step's learning
rate, the clip itself, the "auto" resolutions on the CPU, and Trainer
and train_model through both input pipelines."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.torch_port import SMALL, model_pair, t
from vqvaehmm_tpu import TrainState as JaxTrainState
from vqvaehmm_tpu.train.trainer import make_lr_schedule as jax_schedule
from vqvaehmm_tpu.train.trainer import make_optimizer as jax_optimizer
from vqvaehmm_tpu.train.trainer import make_train_step
from vqvaehmm_tpu_torch import ModelConfig, VAEHMM
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
from vqvaehmm_tpu_torch.data.dataset import RandomChunkDataset
from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences
from vqvaehmm_tpu_torch.train.trainer import (
    Trainer, beta_schedule, clip_by_global_norm_, make_lr_schedule,
    make_optimizer, resolve_fused, resolve_input_pipeline, train_model,
    train_step)

SCHEDULES = {"constant": {},
             "cosine": dict(schedule="cosine", warmup_steps=4,
                            total_steps=24, final_lr_frac=0.1)}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_trajectory_matches_jax(schedule):
    kw = SCHEDULES[schedule]
    B, T, LR, CLIP, EPOCHS, BATCHES = 4, 16, 1e-3, 1.0, 8, 3
    jm, params, tm = model_pair(seed=3)
    tx = jax_optimizer(LR, gradient_clip=CLIP, **kw)
    state = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(jm, tx, donate=False)
    opt = make_optimizer(tm, LR, gradient_clip=CLIP, **kw)

    rng = np.random.default_rng(11)
    jl, tl = [], []
    for ep in range(EPOCHS):
        beta = beta_schedule(ep, EPOCHS)
        for _ in range(BATCHES):
            x = rng.normal(size=(B, 5, T)).astype(np.float32)
            u = rng.normal(size=(B, 4, T)).astype(np.float32)
            lengths = rng.integers(T // 2, T + 1, size=B).astype(np.int32)
            lengths[0] = T
            state, loss = step(state, jnp.asarray(x), jnp.asarray(u),
                               jnp.asarray(lengths), jnp.float32(beta))
            jl.append(float(loss))
            tl.append(float(train_step(tm, opt, t(x), t(u), t(lengths),
                                       beta)))
    assert opt.updates == EPOCHS * BATCHES
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                    state.params))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2e-4, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_jax(kind):
    kw = dict(warmup_steps=5, total_steps=30, final_lr_frac=0.2)
    ours = make_lr_schedule(3e-3, kind, **kw)
    theirs = jax_schedule(3e-3, kind, **kw)
    for step in range(36):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6,
                                           abs=1e-12), step
    assert make_lr_schedule(3e-3) == 3e-3


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(int(scale * 10))
    arrays = [(scale * rng.normal(size=s)).astype(np.float32)
              for s in ((3, 4), (5,), (2, 2, 3))]
    grads = [torch.from_numpy(a.copy()) for a in arrays]
    clip_by_global_norm_(grads, 1.0)
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(a) for a in arrays], optax.EmptyState())
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_resolve_on_cpu():
    cfg = ModelConfig(**SMALL)
    logs = []
    assert resolve_input_pipeline("auto", "cpu") == "host"
    assert resolve_input_pipeline("auto", torch.device("cuda")) == "device"
    assert resolve_input_pipeline("device", "cpu") == "device"
    with pytest.raises(ValueError):
        resolve_input_pipeline("gpu", "cpu")
    assert resolve_fused("auto", cfg, 64, 200, "cpu") is False
    assert resolve_fused("auto", cfg, 64, 200, torch.device("cuda")) is True
    assert resolve_fused(True, cfg, 64, 200, "cpu", log_fn=logs.append)
    assert resolve_fused(False, cfg, 64, 200, "cuda") is False
    big_k = ModelConfig(**{**SMALL, "K": 17})
    # a shape the gate refuses: logged and plain on the CPU, where the
    # plain version runs anyway; on the card only fused=False is plain
    assert resolve_fused(True, big_k, 64, 200, "cpu",
                         log_fn=logs.append) is False
    assert logs and "plain path" in logs[0]
    assert resolve_fused("auto", big_k, 64, 200, "cpu") is False
    assert resolve_fused(False, big_k, 64, 200, "cuda") is False
    for value in (True, "auto"):
        with pytest.raises(ValueError, match="fused=False"):
            resolve_fused(value, big_k, 64, 200, torch.device("cuda"))
    with pytest.raises(ValueError):
        resolve_fused("yes", cfg, 64, 200, "cpu")
    # the device has no default: nothing resolves to the CPU path unasked
    with pytest.raises(TypeError):
        resolve_input_pipeline("auto")
    with pytest.raises(TypeError):
        resolve_fused("auto", cfg, 64, 200)


def _small_training_set():
    xs, us, _ = synthetic_sequences(6, 150, seed=0)
    ds = RandomChunkDataset(xs, us, min_len=20, max_len=64,
                            samples_per_epoch=128, seed=0)
    return ds, VAEHMM(ModelConfig(5, 32, 3, 16, u_dim=4, trans_hidden=32))


@pytest.mark.parametrize("device_data", [False, True])
def test_trainer_loss_falls(device_data):
    ds, model = _small_training_set()
    trainer = Trainer(model, lr=1e-3, gradient_clip=1.0, seed=0,
                      device_data=device_data)
    hist = trainer.train(ds, num_epochs=10, batch_size=32, log_fn=None)
    assert trainer.state.step == 10 * 4
    assert np.isfinite(hist).all()
    assert hist[-1] < hist[5], hist      # beta is 1 from epoch 5 on


@pytest.mark.parametrize("device_data", [False, True])
def test_train_model_loss_falls(device_data):
    ds, model = _small_training_set()
    state, hist = train_model(model, ds, num_epochs=10, lr=1e-3,
                              batch_size=32, device="cpu",
                              device_data=device_data, log_fn=None)
    assert state.step == 10 * 4
    assert hist[-1] < hist[5], hist      # beta is 1 from epoch 5 on
    if not torch.cuda.is_available():
        # no quiet move to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_model(model, ds, num_epochs=1, device="cuda", log_fn=None)
