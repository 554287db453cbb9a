"""The port's window gather (vqvaehmm_tpu_torch/ops/gather.py) against the
JAX package's Pallas gather kernel in interpret mode, reshaped from its
(C, B*T) token layout to (B, C, T), and against the host collate: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvaehmm_tpu.ops import pallas_gather as pg
from vqvaehmm_tpu_torch.data.dataset import collate_fn
from vqvaehmm_tpu_torch.ops.gather import (build_pools, gather_epoch,
                                           gather_windows,
                                           validate_triples)

LENS = (60, 100, 96, 120, 48, 80, 111)


def _pool(T, seed=0, C=5, U=4):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(C, L)).astype(np.float32) for L in LENS]
    us = [rng.normal(size=(U, L)).astype(np.float32) for L in LENS]
    return xs, us


def _draw(rng, B, T, min_len=12):
    si = rng.integers(0, len(LENS), size=B)
    seq_len = np.array(LENS)[si]
    ln = rng.integers(min(min_len, T), np.minimum(T, seq_len) + 1)
    st = rng.integers(0, seq_len - ln + 1)
    st[0] = seq_len[0] - ln[0]                 # a window at the very end
    return [a.astype(np.int32) for a in (si, st, ln)]


@pytest.mark.parametrize("B,T", [(16, 48), (8, 32), (16, 8), (64, 40)])
def test_gather_matches_jax_and_collate(B, T):
    xs, us = _pool(T)
    si, st, ln = _draw(np.random.default_rng(B), B, T)
    validate_triples(si, st, ln, np.array(LENS), T)
    px, pu = (torch.from_numpy(a) for a in build_pools(xs, us))
    before = gather_epoch.launches
    x, u = gather_windows(px, pu, *(torch.from_numpy(a) for a in
                                    (si, st, ln)), T)
    assert gather_epoch.launches == before          # CPU: plain version
    assert x.shape == (B, 5, T) and u.shape == (B, 4, T)

    pool = jnp.asarray(pg.build_token_pool(xs, us, T))
    assert pg.gather_supported(pool.shape, B, T)
    xt, ut = pg.gather_tokens(pool, jnp.asarray(si), jnp.asarray(st),
                              jnp.asarray(ln), T, 5, 4, interpret=True)
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(xt).reshape(5, B, T).transpose(1, 0, 2))
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(ut).reshape(4, B, T).transpose(1, 0, 2))

    hx, hu, _ = collate_fn([(xs[i][:, s:s + n], us[i][:, s:s + n], n)
                            for i, s, n in zip(si, st, ln)], pad_to=T)
    np.testing.assert_array_equal(x.numpy(), hx)
    np.testing.assert_array_equal(u.numpy(), hu)


def test_gather_rejects_bad_windows():
    seq_lens = np.array(LENS)
    ok = [np.array([v], np.int32) for v in (1, 0, 20)]
    validate_triples(*ok, seq_lens, 32)
    for si, st, ln in ((7, 0, 20), (-1, 0, 20), (0, 50, 20), (0, 0, 33),
                       (0, -1, 5)):
        with pytest.raises(ValueError):
            validate_triples(*(np.array([v], np.int32) for v in
                               (si, st, ln)), seq_lens, 32)
    px, pu = (torch.from_numpy(a) for a in build_pools(*_pool(8)))
    with pytest.raises(ValueError, match="CUDA"):
        gather_windows(px, pu, *(torch.from_numpy(a) for a in ok), 32,
                       use_kernel=True)
