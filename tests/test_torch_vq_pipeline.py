"""The port's VQ training pipeline (vqvaehmm_tpu_torch/train/vq_pipeline.py)
on the CPU: a 3-epoch trajectory against the JAX package's train_vq_stack
from JAX's own initial parameters and EM draws (epoch losses <= 1e-4
relative, parameters and HMM <= 1e-3 after 12 Adam steps and 4 EM
iterations, both float32 with other summation orders), the codebook
learning-rate scale, a SIGTERM resume and a rerun that reproduce the
uninterrupted archive bit for bit, and the archive crossing between the
two packages both ways."""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, t
from vqvaehmm_tpu_torch.core.config import (apply_overrides,
                                            config_from_dict, load_config)
from vqvaehmm_tpu_torch.data.checkpoint import (VQ_LEAF_ORDER, load_metadata,
                                                vq_params_from_numpy)
from vqvaehmm_tpu_torch.data.dataset import RandomChunkDataset
from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences
from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline, main
from vqvaehmm_tpu_torch.train.vq_pipeline import (VQStack,
                                                  make_vq_epoch_step,
                                                  make_vq_model,
                                                  make_vq_optimizer,
                                                  panel_windows,
                                                  train_vq_stack)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = os.path.join(ROOT, "artifacts", "checkpoints_vq", "vq_stack.npz")


@pytest.fixture
def tiny(tmp_path):
    xs, us, _ = synthetic_sequences(4, 60, 5, 4, 3, seed=0, stickiness=0.95)
    np.save(tmp_path / "x.npy", xs)
    np.save(tmp_path / "u.npy", us)
    cfg = {
        "model": {"input_dim": 5, "hidden_dim": 8, "K": 3, "hidden_dim2": 4,
                  "u_dim": 4, "trans_hidden": 8, "family": "vqvae"},
        "vq": {"num_codes": 4, "latent_dim": 4, "hmm_iters": 4,
               "hmm_restarts": 2},
        "data": {"x_sequences_path": str(tmp_path / "x.npy"),
                 "u_sequences_path": str(tmp_path / "u.npy"),
                 "min_len": 8, "max_len": 24, "samples_per_epoch": 32},
        "training": {"epochs": 3, "lr": 3e-3, "batch_size": 8,
                     "save_freq": 0, "input_pipeline": "host",
                     "checkpoint_dir": str(tmp_path / "ckpt"), "seed": 0},
    }
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    return str(p), tmp_path


def _cfg(path, tmp, name, *extra, **training):
    over = [f"training.checkpoint_dir={tmp / name}", *extra]
    over += [f"training.{k}={json.dumps(v)}" for k, v in training.items()]
    return apply_overrides(load_config(path), over)


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k].copy() for k in z.files}


def test_three_epoch_trajectory_follows_jax(tiny, monkeypatch):
    from vqvaehmm_tpu.core.config import load_config as jax_load_config
    from vqvaehmm_tpu.data import dataset as jax_dataset
    from vqvaehmm_tpu.train import vq_pipeline as jax_vq

    path, tmp = tiny
    # the numpy sample stream on the JAX side too (its C sampler, where it
    # is built, draws another stream)
    monkeypatch.setattr(jax_dataset, "_fastdata", None)
    xs, us = np.load(tmp / "x.npy"), np.load(tmp / "u.npy")
    jcfg, cfg = jax_load_config(path), load_config(path)
    kw = dict(min_len=8, max_len=24, samples_per_epoch=32, seed=0)
    want, _, _ = jax_vq.train_vq_stack(
        jcfg, jax_dataset.RandomChunkDataset(xs, us, **kw), log_fn=None)

    # what JAX drew inside: the initial parameters (train_vq_stack) and
    # the EM restarts' starting points (fit_categorical_em)
    seed, K, V = cfg.training.seed, cfg.model.K, cfg.vq.num_codes
    init = jax_vq.make_vq_model(jcfg).init(jax.random.PRNGKey(seed))
    draws = []
    for key in jax.random.split(jax.random.PRNGKey(seed),
                                cfg.vq.hmm_restarts):
        k1, k2, k3 = jax.random.split(key, 3)
        draws.append((
            jnp.log(jax.random.dirichlet(k1, jnp.ones(K))),
            jnp.log(jax.random.dirichlet(k2, jnp.full(K, 2.0), shape=(K,))),
            jnp.log(jax.random.dirichlet(k3, jnp.ones(V), shape=(K,)))))
    em_init = tuple(np.stack([np.asarray(d[i]) for d in draws])
                    for i in range(3))
    logs = []
    got, state, preempted = train_vq_stack(
        cfg, RandomChunkDataset(xs, us, **kw), log_fn=logs.append,
        device="cpu", em_init=em_init,
        init_state=vq_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, init)))
    # 3 epochs, and the final polish's where the panel has a dead code
    assert not preempted and len(got.history) == len(want.history) >= 3
    assert state.step == len(got.history) * (32 // 8)
    assert sum(m.startswith("Epoch ") for m in logs) == 3
    np.testing.assert_allclose(got.history, want.history, rtol=1e-4)
    sd = got.model.state_dict()
    for key, leaf in zip(VQ_LEAF_ORDER,
                         jax.tree_util.tree_leaves(want.params)):
        close(sd[key], leaf, 1e-3, key)
    assert got.usage == want.usage
    close(torch.exp(got.hmm.log_A), jnp.exp(want.hmm.log_A), 1e-3)
    close(torch.exp(got.hmm.emission.logits),
          jnp.exp(want.hmm.emission.logits), 1e-3)


def test_panel_windows_cover_every_step_once():
    rng = np.random.default_rng(0)
    seqs = [rng.normal(size=(5, n)).astype(np.float32) for n in (50, 24, 7)]
    x, lens = panel_windows(seqs, 24)
    assert x.shape == (5, 5, 24) and lens.tolist() == [24, 24, 2, 24, 7]
    np.testing.assert_array_equal(x[2, :, :2], seqs[0][:, 48:])
    assert not x[2, :, 2:].any()
    _, lens = panel_windows(seqs, 24, min_len=5)
    assert lens.tolist() == [24, 24, 24, 7]      # a short tail is dropped


def test_codebook_lr_scale_acts_on_the_update():
    """scale 0 freezes the codebook while the rest trains; after one step
    from one start the scale-2 codebook step is twice the scale-1 step
    (on the gradient the factor would cancel inside Adam)."""
    cfg = config_from_dict({
        "model": {"input_dim": 5, "hidden_dim": 8, "hidden_dim2": 4,
                  "family": "vqvae"},
        "vq": {"num_codes": 4, "latent_dim": 4}})
    rng = np.random.default_rng(0)
    xs = t(rng.normal(size=(2, 8, 5, 16)).astype(np.float32))
    lens = torch.full((2, 8), 16, dtype=torch.int32)

    def run(scale, n):
        model = make_vq_model(cfg, generator=torch.Generator().manual_seed(0))
        start = model.codebook.detach().clone()
        conv = model.encoder.conv1.weight.detach().clone()
        opt = make_vq_optimizer(model, 1e-2, None, codebook_lr_scale=scale)
        make_vq_epoch_step(model, opt)(xs[:n], lens[:n])
        return (model.codebook.detach().double() - start.double(),
                not torch.equal(conv, model.encoder.conv1.weight))

    frozen, moved = run(0.0, 2)
    assert not frozen.any() and moved
    d1, _ = run(1.0, 1)
    d2, _ = run(2.0, 1)
    assert float(d1.abs().max()) > 0
    np.testing.assert_allclose(d2.numpy(), 2.0 * d1.numpy(), rtol=1e-4,
                               atol=1e-7)


@pytest.mark.parametrize("input_pipeline", ["host", "device"])
def test_sigterm_resume_is_trajectory_exact(tiny, input_pipeline):
    """SIGTERM checkpoints the epoch boundary and publishes no archive; the
    rerun resumes and ends equal to an uninterrupted run bit for bit,
    archive included."""
    path, tmp = tiny
    cfg = _cfg(path, tmp, "sig", num_epochs=5, save_freq=2,
               input_pipeline=input_pipeline)

    def preempt_at_3(msg):
        if msg.startswith("Epoch 3/"):
            os.kill(os.getpid(), signal.SIGTERM)   # handled: sets a flag

    pipe = TrainPipeline(cfg, device="cpu")
    state = pipe.train(log_fn=preempt_at_3)
    assert pipe.preempted and state.step == 3 * (32 // 8)
    assert not (tmp / "sig" / "vq_stack.npz").exists()
    meta = load_metadata(str(tmp / "sig" / "vq_periodic"))
    assert meta["epoch"] == 3 and meta["preempted"]
    assert len(meta["history"]) == 3 and "rng_state" in meta
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL

    logs = []
    pipe2 = TrainPipeline(cfg, device="cpu")
    resumed = pipe2.train(log_fn=logs.append)
    assert not pipe2.preempted and resumed.step >= 5 * (32 // 8)
    assert any("Resumed from epoch 3" in m for m in logs)

    solo = TrainPipeline(_cfg(path, tmp, "solo", num_epochs=5, save_freq=2,
                              input_pipeline=input_pipeline), device="cpu")
    want = solo.train(log_fn=None)
    assert resumed.step == want.step and pipe2.history == solo.history
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            want.model.state_dict().values()):
        assert torch.equal(a, b), name
    a1 = _arrays(tmp / "sig" / "vq_stack.npz")
    a2 = _arrays(tmp / "solo" / "vq_stack.npz")
    assert set(a1) == set(a2)
    for k in a1:
        np.testing.assert_array_equal(a1[k], a2[k], err_msg=k)


def test_rerun_of_completed_command_republishes_same_archive(tiny):
    """dead_code_min_usage above a uniform share forces the final polish;
    the rerun resumes from the polished checkpoint, skips the polish and
    writes the same archive."""
    path, tmp = tiny
    cfg = _cfg(path, tmp, "rerun", "vq.dead_code_min_usage=2.0",
               "vq.final_polish_epochs=1", num_epochs=4, save_freq=2)
    logs1 = []
    first = TrainPipeline(cfg, device="cpu")
    first.train(log_fn=logs1.append)
    assert any("final polish" in m for m in logs1)
    assert any(m.startswith("WARNING: codebook ships") for m in logs1)
    assert len(first.history) == 5                # 4 epochs and the polish
    assert load_metadata(str(tmp / "rerun" / "vq_periodic"))["polished"]
    a1 = _arrays(tmp / "rerun" / "vq_stack.npz")
    logs2 = []
    pipe2 = TrainPipeline(cfg, device="cpu")
    pipe2.train(log_fn=logs2.append)
    assert not pipe2.preempted
    assert not any("final polish" in m for m in logs2)
    a2 = _arrays(tmp / "rerun" / "vq_stack.npz")
    assert set(a1) == set(a2)
    for k in a1:
        np.testing.assert_array_equal(a1[k], a2[k], err_msg=k)


def test_archive_crosses_both_ways(tiny):
    from vqvaehmm_tpu.train.vq_pipeline import VQStack as JaxStack

    # the committed archive, written by the JAX package, read by the port
    ours, theirs = VQStack.load(ARCHIVE, device="cpu"), JaxStack.load(ARCHIVE)
    assert ours.model.cfg.num_codes == 8 and ours.hmm.K == 3
    assert ours.usage == theirs.usage and len(ours.history) == 41
    x = np.random.default_rng(1).normal(size=(2, 5, 30)).astype(np.float32)
    lens = np.array([30, 17], np.int32)
    np.testing.assert_array_equal(ours.codes(t(x)).numpy(),
                                  np.asarray(theirs.codes(jnp.asarray(x))))
    for mode in ("smoothed", "filtered"):
        close(ours.regime_marginals(t(x), t(lens), mode),
              theirs.regime_marginals(jnp.asarray(x), jnp.asarray(lens),
                                      mode), 1e-4, mode)
    np.testing.assert_array_equal(
        ours.viterbi(t(x), t(lens)).numpy(),
        np.asarray(theirs.viterbi(jnp.asarray(x), jnp.asarray(lens))))
    with pytest.raises(ValueError, match="unknown mode"):
        ours.regime_marginals(t(x), mode="viterbi")

    # the port's archive, read by the JAX package: a resave is the same
    # file array for array, and one the port trained loads there
    path, tmp = tiny
    ours.save(str(tmp / "resaved"))                # .npz is appended
    a, b = _arrays(ARCHIVE), _arrays(tmp / "resaved.npz")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert main([path, "training.epochs=1", "--device", "cpu"]) == 0
    trained = str(tmp / "ckpt" / "vq_stack.npz")
    back, mine = JaxStack.load(trained), VQStack.load(trained, device="cpu")
    x = np.load(tmp / "x.npy")[:2, :, :24]
    np.testing.assert_array_equal(np.asarray(back.codes(jnp.asarray(x))),
                                  mine.codes(t(x)).numpy())
    close(mine.regime_marginals(t(x)),
          back.regime_marginals(jnp.asarray(x)), 1e-4)
    np.testing.assert_array_equal(np.asarray(back.hmm.log_A),
                                  mine.hmm.log_A.numpy())


def test_archive_mismatch_raises(tmp_path):
    data = _arrays(ARCHIVE)
    bad = dict(data, vq_0=np.zeros((2, 2), np.float32))
    np.savez(tmp_path / "bad.npz", **bad)
    with pytest.raises(ValueError, match="shape|mismatch"):
        VQStack.load(str(tmp_path / "bad.npz"), device="cpu")
    short = {k: v for k, v in data.items() if k != "vq_12"}
    np.savez(tmp_path / "short.npz", **short)
    with pytest.raises(ValueError, match="12 arrays"):
        VQStack.load(str(tmp_path / "short.npz"), device="cpu")
    meta = np.frombuffer(json.dumps({"family": "gmm"}).encode(), np.uint8)
    np.savez(tmp_path / "notvq.npz", meta=meta)
    with pytest.raises(ValueError, match="vq_stack"):
        VQStack.load(str(tmp_path / "notvq.npz"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VQStack.load(ARCHIVE)
