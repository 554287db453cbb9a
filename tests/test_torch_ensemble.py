"""The port's seed ensembles (vqvaehmm_tpu_torch/train/ensemble.py) on
the CPU: against the JAX package's train_ensemble from JAX's initial
parameters over the same host epoch stream, each member bit-equal to the
port's solo train_model from the same state through both input
pipelines, `best` the argmin, and the gate's CPU fallback."""

import jax
import numpy as np
import pytest
import torch

from tests.torch_port import SMALL
from vqvaehmm_tpu import make_model
from vqvaehmm_tpu.data import dataset as jax_dataset
from vqvaehmm_tpu.train import ensemble as jax_ensemble
from vqvaehmm_tpu_torch import ModelConfig, VAEHMM
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
from vqvaehmm_tpu_torch.data.dataset import RandomChunkDataset
from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences
from vqvaehmm_tpu_torch.train.ensemble import (ensemble_member,
                                               init_ensemble_state,
                                               train_ensemble)
from vqvaehmm_tpu_torch.train.trainer import TrainState, train_model

SEEDS = [0, 1, 2]
KW = dict(num_epochs=3, lr=1e-3, batch_size=8, gradient_clip=1.0)


def _dataset(cls=RandomChunkDataset, max_len=32):
    xs, us, _ = synthetic_sequences(4, 96, 5, 4, 3, seed=0)
    return cls(xs, us, min_len=16, max_len=max_len, samples_per_epoch=32,
               seed=0)


def _model():
    return VAEHMM(ModelConfig(**SMALL))


def test_ensemble_matches_jax(monkeypatch):
    """From JAX's members' initial parameters over the same numpy epoch
    stream (JAX's native sampler off): histories within 1e-5 relative,
    parameters within 1e-4, the same best member."""
    monkeypatch.setattr(jax_dataset, "_fastdata", None)
    jm = make_model(**SMALL)
    jstates, jhist, jbest = jax_ensemble.train_ensemble(
        jm, _dataset(jax_dataset.RandomChunkDataset), SEEDS,
        device_data=False, fused=False, log_fn=None, **KW)
    tx = jax_ensemble.make_optimizer(KW["lr"], KW["gradient_clip"])
    init = jax_ensemble.init_ensemble_state(jm, tx, SEEDS)
    init_states = [params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_ensemble.ensemble_member(init, i).params))
        for i in range(len(SEEDS))]
    states, hist, best = train_ensemble(
        _model(), _dataset(), SEEDS, device_data=False, device="cpu",
        init_states=init_states, log_fn=None, **KW)
    assert hist.shape == (3, 3) and best == jbest
    np.testing.assert_allclose(hist, np.asarray(jhist), rtol=1e-5)
    for i in range(len(SEEDS)):
        want = params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jax_ensemble.ensemble_member(jstates, i).params))
        member = ensemble_member(states, i)
        assert member.step == int(jax_ensemble.ensemble_member(
            jstates, i).step)
        for name, p in member.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"{i} {name}")


@pytest.mark.parametrize("device_data", [False, True])
def test_members_bit_equal_to_solo_runs(device_data):
    logs = []
    states, hist, best = train_ensemble(
        _model(), _dataset(), SEEDS, device_data=device_data, device="cpu",
        log_fn=logs.append, **KW)
    assert best == int(np.argmin(hist[:, -1]))
    assert len(logs) == 3 and "median" in logs[0]
    for i, seed in enumerate(SEEDS):
        solo = init_ensemble_state(_model(), [seed], KW["lr"],
                                   KW["gradient_clip"], "cpu")[0]
        state, solo_hist = train_model(
            solo.model, _dataset(), state=solo, device_data=device_data,
            device="cpu", log_fn=None, num_epochs=3, batch_size=8)
        assert hist[i].tolist() == [np.float32(h) for h in solo_hist]
        member = ensemble_member(states, i)
        assert member.step == state.step == 3 * (32 // 8)
        for (name, a), b in zip(member.model.state_dict().items(),
                                state.model.state_dict().values()):
            assert torch.equal(a, b), (i, name)


def test_member_is_the_seeded_model_and_ties_pick_the_first():
    """Member i's initial parameters are those VAEHMM draws from seed i
    (TrainPipeline.build_model's), and equal members tie: `best` is the
    first of them, as np.argmin."""
    states = init_ensemble_state(_model(), [4, 4], 1e-3, device="cpu")
    fresh = VAEHMM(ModelConfig(**SMALL),
                   generator=torch.Generator().manual_seed(4))
    for s in states:
        for a, b in zip(s.model.state_dict().values(),
                        fresh.state_dict().values()):
            assert torch.equal(a, b)
    assert isinstance(states[0], TrainState)
    _, hist, best = train_ensemble(_model(), _dataset(), [5, 5],
                                   device_data=False, device="cpu",
                                   log_fn=None, **KW)
    assert hist[0].tolist() == hist[1].tolist() and best == 0


def test_fused_gate_falls_back_on_the_cpu():
    """fused=True at a shape the kernel's gate refuses logs and trains on
    the plain path on the CPU (JAX's
    test_train_ensemble_fused_gate_falls_back); on a CUDA device the same
    request raises (train/trainer.py::resolve_fused)."""
    msgs = []
    model = VAEHMM(ModelConfig(**{**SMALL, "K": 17}))
    _, hist, _ = train_ensemble(model, _dataset(), [0, 1], num_epochs=1,
                                batch_size=16, device_data=False,
                                fused=True, device="cpu",
                                log_fn=msgs.append)
    assert any("plain path" in m for m in msgs)
    assert hist.shape == (2, 1) and np.isfinite(hist).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_ensemble(model, _dataset(), [0], log_fn=None)


def test_pipeline_branch_writes_what_jax_writes(tmp_path, monkeypatch):
    """training.ensemble_seeds through both packages' TrainPipeline on one
    config: the same metadata keys and seeds, one member's steps, and an
    `.npz` of the same parameter paths beside the checkpoint (after
    tests/test_pipeline.py::test_pipeline_ensemble_seeds)."""
    import json

    from vqvaehmm_tpu.core.config import load_config as jax_load_config
    from vqvaehmm_tpu.data.checkpoint import load_metadata as jax_metadata
    from vqvaehmm_tpu.train.pipeline import TrainPipeline as JaxPipeline
    from vqvaehmm_tpu_torch.core.config import load_config
    from vqvaehmm_tpu_torch.data.checkpoint import load_metadata
    from vqvaehmm_tpu_torch.train.pipeline import TrainPipeline

    monkeypatch.setattr(jax_dataset, "_fastdata", None)
    xs, us, _ = synthetic_sequences(4, 120, 5, 4, 3, seed=0)
    np.save(tmp_path / "x.npy", xs)
    np.save(tmp_path / "u.npy", us)
    dirs = {}
    for name in ("jax", "port"):
        dirs[name] = tmp_path / name
        (tmp_path / f"{name}.json").write_text(json.dumps({
            "model": SMALL,
            "data": {"x_sequences_path": str(tmp_path / "x.npy"),
                     "u_sequences_path": str(tmp_path / "u.npy"),
                     "min_len": 16, "max_len": 48, "samples_per_epoch": 32},
            "training": {"epochs": 2, "lr": 1e-3, "batch_size": 8,
                         "seed": 1, "ensemble_seeds": [0, 1, 2],
                         "checkpoint_dir": str(dirs[name])}}))
    jstate = JaxPipeline(jax_load_config(str(tmp_path / "jax.json"))).train(
        log_fn=None)
    state = TrainPipeline(load_config(str(tmp_path / "port.json")),
                          device="cpu").train(log_fn=None)
    want = jax_metadata(str(dirs["jax"] / "vae_hmm_trained"))
    got = load_metadata(str(dirs["port"] / "vae_hmm_trained"))
    assert sorted(got) == sorted(want)
    assert got["ensemble_seeds"] == want["ensemble_seeds"] == [0, 1, 2]
    assert got["epochs"] == want["epochs"] == 2
    assert got["final_loss"] == min(got["per_member_final_loss"])
    assert state.step == int(jstate.step) == 2 * (32 // 8)
    with np.load(dirs["jax"] / "vae_hmm_trained.npz") as a, \
            np.load(dirs["port"] / "vae_hmm_trained.npz") as b:
        assert sorted(a.files) == sorted(b.files)
