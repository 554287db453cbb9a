"""The throughput configuration (compute_dtype "bfloat16") of the port's
training path on the CPU, against the JAX package.

Kernel C's bfloat16 mode rounds both operands of every product to
bfloat16 and keeps every other value float32, as TPU kernel 5's
bf16_matmuls mode does (vqvaehmm_tpu/ops/pallas_train.py::_make_dots).
On the CPU the port computes its plain version (compute_loss with
bf16_operands=True plus autograd), held against the JAX kernel in
interpret mode: loss within 1e-5 relative, every gradient within 1e-4 of
its leaf's largest entry (a product of two bfloat16 values is exact in
float32, so only the order of the float32 sums differs: measured at most
1.3e-6 and 9.7e-7 at these widths).  JAX's float32 kernel is more than
1e-2 of some leaf's largest entry away (measured 0.13 and 0.16), so a
port that forgot to round fails."""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import SMALL, inputs, model_pair, t
from vqvaehmm_tpu import TrainState as JaxTrainState
from vqvaehmm_tpu import make_model
from vqvaehmm_tpu.ops.pallas_train import fused_loss_and_grads as jax_fused
from vqvaehmm_tpu.train.trainer import make_optimizer as jax_optimizer
from vqvaehmm_tpu.train.trainer import make_train_step
from vqvaehmm_tpu_torch import ModelConfig, VAEHMM
from vqvaehmm_tpu_torch.core.config import apply_overrides, load_config
from vqvaehmm_tpu_torch.data.checkpoint import (load_metadata,
                                                params_from_numpy)
from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences
from vqvaehmm_tpu_torch.ops.fused_train import (PARAM_NAMES, bf16_mode,
                                                fused_loss_and_grads,
                                                fused_loss_and_grads_reference,
                                                fused_loss_and_grads_tiled,
                                                loss_and_grads,
                                                train_step_supported)
from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline
from vqvaehmm_tpu_torch.train.trainer import (make_optimizer, resolve_fused,
                                              train_step)
from vqvaehmm_tpu_torch.utils.benchmarking import (
    saturated_marginal, saturated_marginal_windows)

BF16 = dict(compute_dtype="bfloat16", matmul_precision="default")


def _state(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _worst(got, want):
    """max over leaves of max|got - want| / max|want|."""
    return max(float((got[n] - want[n]).abs().max())
               / float(want[n].abs().max()) for n in want)


def _check(loss, grads, want_loss, want, rel_loss=1e-5, rel_grad=1e-4):
    assert set(grads) == set(want) == set(PARAM_NAMES)
    assert abs(float(loss) - float(want_loss)) \
        <= rel_loss * abs(float(want_loss))
    for name, w in want.items():
        assert grads[name].shape == w.shape, name
        err = float((grads[name] - w).abs().max())
        assert err <= rel_grad * float(w.abs().max()), (name, err)


@pytest.mark.parametrize("widths,B,T,beta,short,layout", [
    (SMALL, 4, 32, 1.0, None, "BUT"),
    (SMALL, 4, 32, 0.5, 20, "BTU"),                  # valid_to inside T
    (dict(input_dim=7, hidden_dim=24, K=2, hidden_dim2=8, u_dim=3,
          trans_hidden=16), 4, 24, 0.5, None, "BUT"),
    (dict(input_dim=3, hidden_dim=16, K=4, hidden_dim2=12, u_dim=5,
          trans_hidden=8), 3, 16, 1.0, 11, "BTU")])
def test_plain_bf16_mode_matches_jax_kernel(widths, B, T, beta, short,
                                            layout):
    """(a) Kernel C's plain bfloat16 version against TPU kernel 5 in
    bf16_matmuls mode (interpret mode): ragged lengths, beta 0.5 and 1,
    both u layouts, fuzzed widths; JAX's float32 kernel is far off."""
    jm, params, tm = model_pair(seed=B + T, **widths, **BF16)
    x, u, lengths = inputs(B, T, seed=T, C=widths["input_dim"],
                           U=widths["u_dim"])
    if short is not None:
        lengths = np.minimum(lengths, short)
    if layout == "BTU":
        u = np.ascontiguousarray(u.transpose(0, 2, 1))
    assert bf16_mode(tm.cfg) and train_step_supported(tm.cfg, B, T)
    loss, grads = fused_loss_and_grads(tm, t(x), t(u), t(lengths), beta)
    args = (params, jnp.asarray(x), jnp.asarray(u), jnp.asarray(lengths),
            beta)
    k_loss, k_grads = jax_fused(jm, *args, interpret=True)
    _check(loss, grads, k_loss, _state(k_grads))
    if widths is SMALL:
        # one float32 kernel shape is compiled, for the two SMALL cases
        _, k32 = jax_fused(make_model(**widths), *args, interpret=True)
        assert _worst(grads, _state(k32)) > 1e-2


@pytest.mark.parametrize("B,T,tile,short,layout,beta,splits", [
    (3, 40, 16, None, "BUT", 1.0, 3),
    (3, 45, 8, 29, "BTU", 0.1, 1),
    (4, 70, 16, 20, "BUT", 0.5, 5)])
def test_tiled_version_in_bf16_mode(B, T, tile, short, layout, beta,
                                    splits):
    """(b) The plain version that follows the kernel's tiling, in the
    bfloat16 mode, equals the reference plain version (loss 1e-5
    relative, gradients 1e-4 of each leaf's largest entry; measured 5e-7
    and 3.3e-7), and not the float32 model's (measured 1.7e-2 to
    6.4e-2)."""
    _, _, tm = model_pair(seed=11, **BF16)
    x, u, lengths = inputs(B, T, seed=T + tile)
    if short is not None:
        lengths = np.minimum(lengths, short)
    if layout == "BTU":
        u = np.ascontiguousarray(u.transpose(0, 2, 1))
    args = (tm, t(x), t(u), t(lengths), beta)
    loss, grads = fused_loss_and_grads_tiled(*args, tile, splits=splits)
    _check(loss, grads, *fused_loss_and_grads_reference(*args))
    # the float32 model's tiled version is another function
    _, _, tm32 = model_pair(seed=11)
    _, g32 = fused_loss_and_grads_tiled(tm32, *args[1:], tile, splits=splits)
    assert _worst(grads, g32) > 1e-2


def test_trainer_steps_match_jax_fused_bf16_step():
    """(d) Three updates (clip 1.0) of a bfloat16 model through the
    trainer's fused step (its plain version here) against JAX's fused
    step with TPU kernel 5 in bf16_matmuls mode, from a shared init on
    shared batches: losses within 1e-5 relative, parameters within 1e-6
    (measured 1.2e-7)."""
    B, T, LR = 4, 32, 1e-3
    jm, params, tm = model_pair(seed=21, **BF16)
    tx = jax_optimizer(LR, gradient_clip=1.0)
    state = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = make_train_step(jm, tx, donate=False, fused=True)
    opt = make_optimizer(tm, LR, gradient_clip=1.0)
    rng = np.random.default_rng(22)
    for beta in (0.2, 0.6, 1.0):
        x, u, lengths = inputs(B, T, seed=int(rng.integers(1 << 30)))
        state, jl = step(state, jnp.asarray(x), jnp.asarray(u),
                         jnp.asarray(lengths), jnp.float32(beta))
        tl = train_step(tm, opt, t(x), t(u), t(lengths), beta, fused=True)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = _state(state.params)
    for name, p in tm.named_parameters():
        assert p.dtype == torch.float32
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_resolve_fused_and_the_two_plain_paths():
    """(e) resolve_fused answers for a bfloat16 model as for a float32 one
    (the gate takes both dtypes); fused=False is compute_loss and autograd
    with bfloat16 activations, the kernel's plain version is the other
    bfloat16 arithmetic."""
    cfg = ModelConfig(**SMALL, **BF16)
    assert resolve_fused("auto", cfg, 64, 200, "cuda") is True
    assert resolve_fused("auto", cfg, 64, 200, "cpu") is False
    assert resolve_fused(True, cfg, 64, 200, "cpu") is True
    assert resolve_fused(False, cfg, 64, 200, "cuda") is False
    with pytest.raises(ValueError, match="fused=False"):
        resolve_fused(True, ModelConfig(**{**SMALL, "K": 17}, **BF16), 64,
                      200, "cuda")
    _, _, tm = model_pair(seed=2, **BF16)
    x, u, lengths = (t(a) for a in inputs(3, 24, seed=4))
    plain = loss_and_grads(tm, x, u, lengths, 1.0)
    kernel = fused_loss_and_grads_reference(tm, x, u, lengths, 1.0)
    assert plain[0] != kernel[0]
    assert torch.equal(plain[0], tm.compute_loss(x, u, lengths, 1.0).detach())
    assert torch.equal(kernel[0], tm.compute_loss(
        x, u, lengths, 1.0, bf16_operands=True).detach())


@pytest.fixture
def bf16_config(tmp_path):
    xs, us, _ = synthetic_sequences(4, 120, 5, 4, 3, seed=0)
    np.save(tmp_path / "x.npy", xs)
    np.save(tmp_path / "u.npy", us)
    cfg = {
        "model": {**SMALL, **BF16},
        "data": {"x_sequences_path": str(tmp_path / "x.npy"),
                 "u_sequences_path": str(tmp_path / "u.npy"),
                 "min_len": 16, "max_len": 32, "samples_per_epoch": 32},
        "training": {"epochs": 4, "lr": 1e-3, "batch_size": 8,
                     "gradient_clip": 1.0, "save_freq": 2, "fused": True,
                     "checkpoint_dir": str(tmp_path / "ckpt"), "seed": 1},
    }
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(cfg))
    return str(p), tmp_path


def test_pipeline_trains_resumes_and_round_trips_with_jax(bf16_config):
    """(f) TrainPipeline in the throughput configuration on the CPU: the
    config keeps compute_dtype and matmul_precision, a SIGTERM resume ends
    bit-equal to the uninterrupted run, the .npz it writes gives JAX's
    bfloat16 model the port's loss, and an archive JAX's bfloat16 pipeline
    wrote loads and gives the port JAX's loss (1e-5 relative)."""
    from vqvaehmm_tpu.core.config import load_config as jax_load_config
    from vqvaehmm_tpu.data.checkpoint import load_params_npz
    from vqvaehmm_tpu.train.pipeline import TrainPipeline as JaxPipeline
    from vqvaehmm_tpu_torch.data.checkpoint import load_params_npz as load_np

    path, tmp = bf16_config
    cfg = load_config(path)
    assert (cfg.model.compute_dtype, cfg.model.matmul_precision) \
        == ("bfloat16", "default")

    def at(name):
        return apply_overrides(cfg, [f"training.checkpoint_dir={tmp / name}"])

    def preempt_at_2(msg):
        if msg.startswith("Epoch 2/"):
            os.kill(os.getpid(), signal.SIGTERM)

    pipe = TrainPipeline(at("sig"), device="cpu")
    assert pipe.train(log_fn=preempt_at_2).step == 2 * 4 and pipe.preempted
    assert load_metadata(str(tmp / "sig" / "vae_hmm_periodic"))["epoch"] == 2
    resumed = TrainPipeline(at("sig"), device="cpu").train(log_fn=None)
    solo_pipe = TrainPipeline(at("solo"), device="cpu")
    solo = solo_pipe.train(log_fn=None)
    assert resumed.step == solo.step == 4 * 4
    assert np.isfinite(solo_pipe.history).all()
    for (name, a), b in zip(resumed.model.state_dict().items(),
                            solo.model.state_dict().values()):
        assert a.dtype == torch.float32 and torch.equal(a, b), name

    x, u, lengths = inputs(3, 40, seed=2)
    jargs = (jnp.asarray(x), jnp.asarray(u), jnp.asarray(lengths), 1.0)
    jm = make_model(**SMALL, **BF16)
    mine = load_params_npz(str(tmp / "solo" / "vae_hmm_trained.npz"))
    with torch.no_grad():
        got = float(solo.model.compute_loss(t(x), t(u), t(lengths), 1.0))
    want = float(jm.compute_loss(mine, *jargs))
    assert abs(got - want) <= 1e-5 * abs(want)

    jcfg = jax_load_config(path)
    from vqvaehmm_tpu.core.config import apply_overrides as jax_over
    jcfg = jax_over(jcfg, [f"training.checkpoint_dir={tmp / 'jax'}",
                           "training.num_epochs=1", "training.fused=false"])
    JaxPipeline(jcfg).train(log_fn=None)
    archive = str(tmp / "jax" / "vae_hmm_trained.npz")
    tm = VAEHMM(cfg.model)
    tm.load_state_dict(params_from_numpy(load_np(archive)))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        got = float(tm.compute_loss(t(x), t(u), t(lengths), 1.0))
    want = float(jm.compute_loss(load_params_npz(archive), *jargs))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_bf16_ensemble_of_two_matches_jax(monkeypatch):
    """(h) Two bfloat16 members through the fused step (its plain version
    here) against JAX's fused bfloat16 ensemble from JAX's initial
    parameters over the same numpy epoch stream: histories within 1e-5
    relative, parameters within 1e-5, the same best member."""
    from vqvaehmm_tpu.data import dataset as jax_dataset
    from vqvaehmm_tpu.train import ensemble as jax_ensemble
    from vqvaehmm_tpu_torch.data.dataset import RandomChunkDataset
    from vqvaehmm_tpu_torch.train.ensemble import (ensemble_member,
                                                   train_ensemble)

    monkeypatch.setattr(jax_dataset, "_fastdata", None)
    seeds, kw = [0, 1], dict(num_epochs=2, lr=1e-3, batch_size=8,
                             gradient_clip=1.0)

    def dataset(cls):
        xs, us, _ = synthetic_sequences(4, 96, 5, 4, 3, seed=0)
        return cls(xs, us, min_len=16, max_len=32, samples_per_epoch=32,
                   seed=0)

    jm = make_model(**SMALL, **BF16)
    jstates, jhist, jbest = jax_ensemble.train_ensemble(
        jm, dataset(jax_dataset.RandomChunkDataset), seeds,
        device_data=False, fused=True, log_fn=None, **kw)
    tx = jax_ensemble.make_optimizer(kw["lr"], kw["gradient_clip"])
    init = jax_ensemble.init_ensemble_state(jm, tx, seeds)
    init_states = [_state(jax_ensemble.ensemble_member(init, i).params)
                   for i in range(len(seeds))]
    states, hist, best = train_ensemble(
        VAEHMM(ModelConfig(**SMALL, **BF16)), dataset(RandomChunkDataset),
        seeds, device_data=False, fused=True, device="cpu",
        init_states=init_states, log_fn=None, **kw)
    assert hist.shape == (2, 2) and best == jbest
    np.testing.assert_allclose(hist, np.asarray(jhist), rtol=1e-5)
    for i in range(len(seeds)):
        want = _state(jax_ensemble.ensemble_member(jstates, i).params)
        got = ensemble_member(states, i).model.state_dict()
        for name in want:
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)


def test_saturated_marginal_on_a_fake_timer():
    """(i) utils/benchmarking.py: R sized from the estimate, both repeat
    counts warmed, the marginal (t(2R) - t(R)) / R over medians, windows
    with their median and range; the default timer needs a card."""
    calls = []

    def make_repeat(R):
        return lambda: R

    costs = iter(range(10 ** 6))

    def timer(fn):
        R = fn()
        calls.append(R)
        # 3 us a repeat, a fixed 5 ms a call, and a jitter of 0-2 us
        return (5.0 + 3e-3 * R + 1e-3 * (next(costs) % 3)) / 1.0

    us, R = saturated_marginal(make_repeat, est_us=500.0, floor_ms=50.0,
                               trials=3, timer=timer)
    assert R == 100 and calls[:2] == [100, 200]
    assert us == pytest.approx(3.0, abs=0.03)
    calls.clear()
    med, lo, hi, R = saturated_marginal_windows(
        make_repeat, est_us=1.0, floor_ms=1.0, windows=5, trials=3,
        timer=timer)
    assert R == 1000 and len(calls) == 2 + 5 * 2 * 3
    assert lo <= med <= hi and med == pytest.approx(3.0, abs=0.01)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            saturated_marginal(make_repeat, est_us=1e6, trials=1)
