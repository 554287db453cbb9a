"""The port's data pipeline (vqvaehmm_tpu_torch/data/) against the JAX
package's: the same seed gives the same index triples and bit-equal
epochs, also through the one-launch epoch gather (ops/gather.py::
gather_epoch, its plain version here); epoch_skip stays in lockstep with
epoch_arrays; make_epoch_step's chunked gather trains as a gather a step
did."""

import numpy as np
import pytest
import torch

from vqvaehmm_tpu.data.dataset import RandomChunkDataset as JaxDataset
from vqvaehmm_tpu.data.dataset import epoch_arrays as jax_epoch_arrays
from vqvaehmm_tpu.data.device_sampler import \
    DeviceEpochSampler as JaxSampler
from vqvaehmm_tpu_torch.data.dataset import (RandomChunkDataset,
                                             epoch_arrays, epoch_skip)
from vqvaehmm_tpu_torch.data.device_sampler import DeviceEpochSampler
from vqvaehmm_tpu_torch.data.synthetic import synthetic_sequences


def _sources():
    xs, us, _ = synthetic_sequences(4, 90, 5, 4, 3, seed=3)
    lens = (90, 70, 55, 83)
    return ([x[:, :n] for x, n in zip(xs, lens)],
            [u[:, :n] for u, n in zip(us, lens)])


def _pair(seed=7):
    xs, us = _sources()
    kw = dict(min_len=10, max_len=40, samples_per_epoch=32, seed=seed)
    return RandomChunkDataset(xs, us, **kw), JaxDataset(xs, us, **kw)


@pytest.mark.parametrize("fast", [False, True])
def test_sample_indices_match_jax(fast):
    ours, theirs = _pair()
    s, j = DeviceEpochSampler(ours, "cpu"), JaxSampler(theirs)
    for _ in range(2):
        got = (s.sample_indices_fast if fast else s.sample_indices)(8, 3)
        want = (j.sample_indices_fast if fast else j.sample_indices)(8, 3)
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.shape == (3, 8)
            np.testing.assert_array_equal(g, w)


def test_device_epoch_matches_host_epoch_arrays():
    """epoch(exact_stream=True) gathers the numpy host stream bit for bit:
    the port's and the JAX package's (use_native=False) host epochs."""
    ours, theirs = _pair()
    ours_host, _ = _pair()
    x, u, lens = DeviceEpochSampler(ours, "cpu").epoch(8)
    jx, ju, jl = jax_epoch_arrays(theirs, 8, use_native=False)
    hx, hu, hl = epoch_arrays(ours_host, 8)
    for got, want, host in ((x, jx, hx), (u, ju, hu), (lens, jl, hl)):
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(host, want)


def test_epoch_skip_in_lockstep():
    ours_full, _ = _pair(seed=11)
    ours_skip, _ = _pair(seed=11)
    epoch_arrays(ours_full, 8)
    epoch_skip(ours_skip, 8)
    for a, b in zip(epoch_arrays(ours_full, 8), epoch_arrays(ours_skip, 8)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match="native"):
        epoch_arrays(ours_full, 8, use_native=True)
    with pytest.raises(NotImplementedError, match="native"):
        epoch_skip(ours_full, 8, use_native=True)


@pytest.mark.parametrize("fast", [False, True])
def test_epoch_gather_matches_jax_epoch(fast, monkeypatch):
    """gather_epoch_reference (and gather_epoch on a CPU tensor, its plain
    version) against the JAX DeviceEpochSampler's one-dispatch epoch
    gather on the same triples: exact.  Chunks of whole batches under a
    small cap give the same epoch as one chunk."""
    from vqvaehmm_tpu_torch.ops import gather
    from vqvaehmm_tpu_torch.ops.gather import (build_pools, gather_epoch,
                                               gather_epoch_chunks,
                                               gather_epoch_reference)

    ours, theirs = _pair(seed=5)
    s, j = DeviceEpochSampler(ours, "cpu"), JaxSampler(theirs)
    draw = s.sample_indices_fast if fast else s.sample_indices
    trip = draw(8, 4)
    jx, ju, _ = j._gather(j.xsrc, j.usrc, *trip)
    px, pu = (torch.from_numpy(a) for a in build_pools(ours.x_seqs,
                                                       ours.u_seqs))
    tt = [torch.from_numpy(a) for a in trip]
    x, u = gather_epoch_reference(px, pu, *tt, ours.max_len)
    assert x.shape == (4, 8, 5, 40) and u.shape == (4, 8, 4, 40)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    got = gather_epoch(px, pu, *tt, ours.max_len)
    assert torch.equal(got[0], x) and torch.equal(got[1], u)
    monkeypatch.setattr(gather, "EPOCH_CHUNK_BYTES", 3 * 4 * 8 * 9 * 40)
    chunks = list(gather_epoch_chunks(px, pu, *tt, ours.max_len))
    assert [c[0] for c in chunks] == [0, 3]
    assert torch.equal(torch.cat([c[1] for c in chunks]), x)
    assert torch.equal(torch.cat([c[2] for c in chunks]), u)


@pytest.mark.parametrize("chunk_bytes", [None, 4 * 8 * 9 * 40])
def test_epoch_step_gathers_in_chunks_as_a_step_would(chunk_bytes,
                                                      monkeypatch):
    """make_epoch_step gathers its epoch in chunks of whole batches before
    the steps; its mean loss and the parameters it leaves are bit-equal to
    a loop with a gather a step (what it did before)."""
    from vqvaehmm_tpu_torch import VAEHMM, ModelConfig
    from vqvaehmm_tpu_torch.ops import gather
    from vqvaehmm_tpu_torch.train.trainer import make_optimizer, train_step

    if chunk_bytes is not None:
        monkeypatch.setattr(gather, "EPOCH_CHUNK_BYTES", chunk_bytes)

    ours, _ = _pair(seed=2)
    sampler = DeviceEpochSampler(ours, "cpu")
    trip = sampler.upload(*sampler.sample_indices_fast(8, 4))
    runs = []
    for chunked in (True, False):
        model = VAEHMM(ModelConfig(input_dim=5, hidden_dim=8, K=3,
                                   hidden_dim2=4, u_dim=4, trans_hidden=8),
                       generator=torch.Generator().manual_seed(1))
        opt = make_optimizer(model, 1e-3, 1.0)
        if chunked:
            loss = sampler.make_epoch_step(model, opt)(*trip, 0.5)
        else:
            loss = torch.zeros(())
            for i in range(4):
                x, u = sampler.gather(*(a[i] for a in trip))
                loss = loss + train_step(model, opt, x, u, trip[2][i], 0.5)
            loss = loss / 4
        runs.append((loss, [p.detach().clone() for p in model.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
