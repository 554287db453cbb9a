"""The port's data pipeline (vqvaehmm_tpu_torch/data/) against the JAX
package's: the same seed gives the same index triples and bit-equal
epochs; epoch_skip stays in lockstep with epoch_arrays."""

import numpy as np
import pytest

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
