"""The port's prefetched host epochs (vqvaehmm_tpu_torch/data/prefetch.py)
on the CPU: every epoch bit-equal to the synchronous epoch_arrays stream,
a producer's exception raised in the consumer, no thread left after an
early stop (after tests/test_trainer.py's prefetch cases), and the
host-fed trainers' losses unchanged by it."""

import threading
import time

import numpy as np
import pytest
import torch

from tests.torch_port import SMALL
from vqvaehmm_tpu_torch import ModelConfig, VAEHMM
from vqvaehmm_tpu_torch.data import prefetch as prefetch_mod
from vqvaehmm_tpu_torch.data.dataset import RandomChunkDataset, epoch_arrays
from vqvaehmm_tpu_torch.data.prefetch import prefetch_epochs
from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences
from vqvaehmm_tpu_torch.train import pipeline as pipeline_mod
from vqvaehmm_tpu_torch.train.trainer import train_model


def _dataset(seed=0):
    xs, us, _ = synthetic_sequences(6, 96, 5, 4, 3, seed=0)
    return RandomChunkDataset(xs, us, min_len=16, max_len=48,
                              samples_per_epoch=64, seed=seed)


def test_prefetched_epochs_equal_the_synchronous_stream():
    got = list(prefetch_epochs(_dataset(), 16, 3, device="cpu"))
    ref = _dataset()
    assert len(got) == 3
    for xs, us, lens in got:
        want = epoch_arrays(ref, 16)
        assert xs.shape == (4, 16, 5, 48) and lens.shape == (4, 16)
        for g, w in zip((xs, us, lens), want):
            assert isinstance(g, torch.Tensor)
            np.testing.assert_array_equal(g.numpy(), w)


def test_producer_error_is_raised_in_the_consumer():
    ds = _dataset()
    ds.x_seqs = None       # epoch_arrays fails on its first draw
    with pytest.raises(TypeError):
        list(prefetch_epochs(ds, 16, 2, device="cpu"))


def test_early_stop_leaves_no_thread():
    before = {t.ident for t in threading.enumerate()}
    gen = prefetch_epochs(_dataset(), 16, 50, buffer_size=1, device="cpu")
    next(gen)
    gen.close()            # the consumer stops after 1 of 50 epochs
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        leaked = [t for t in threading.enumerate()
                  if t.ident not in before and t.is_alive()]
        if not leaked:
            break
        time.sleep(0.05)
    assert not leaked, f"producer thread leaked: {leaked}"


def _synchronous(dataset, batch_size, num_epochs, num_batches=None,
                 buffer_size=2, device="cpu"):
    for _ in range(num_epochs):
        yield tuple(torch.from_numpy(a).to(device) for a in
                    epoch_arrays(dataset, batch_size, num_batches))


def _train(monkeypatch, sync):
    if sync:
        monkeypatch.setattr(prefetch_mod, "prefetch_epochs", _synchronous)
    model = VAEHMM(ModelConfig(**SMALL))
    state, hist = train_model(model, _dataset(), num_epochs=3,
                              batch_size=16, device="cpu",
                              device_data=False, log_fn=None)
    return hist, state.model.state_dict()


def test_train_model_bit_equal_with_and_without_prefetch(monkeypatch):
    h1, p1 = _train(monkeypatch, sync=False)
    h2, p2 = _train(monkeypatch, sync=True)
    assert h1 == h2
    for (name, a), b in zip(p1.items(), p2.values()):
        assert torch.equal(a, b), name


def test_pipeline_bit_equal_with_and_without_prefetch(monkeypatch, tmp_path):
    from vqvaehmm_tpu_torch.core.config import config_from_dict

    cfg = config_from_dict({
        "model": SMALL,
        "data": {"min_len": 16, "max_len": 48, "samples_per_epoch": 32,
                 "x_sequences_path": str(tmp_path / "none.npy")},
        "training": {"epochs": 3, "batch_size": 8, "save_freq": 0,
                     "input_pipeline": "host",
                     "checkpoint_dir": str(tmp_path / "a")}})
    runs = []
    for sync in (False, True):
        if sync:
            monkeypatch.setattr(pipeline_mod, "prefetch_epochs",
                                _synchronous)
        pipe = pipeline_mod.TrainPipeline(cfg, device="cpu")
        state = pipe.train(log_fn=None)
        runs.append((pipe.history, state.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1].values(), runs[1][1].values()):
        assert torch.equal(a, b)
