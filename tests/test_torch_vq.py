"""The port's vector quantization (vqvaehmm_tpu_torch/ops/vq.py) on the
CPU against the JAX package's ops/vq.py on the same numpy inputs: reals
to <= 1e-4 (float32, other summation orders), integers equal.  The JAX
Pallas kernel `vq_pallas` runs in interpret mode, as tests/test_vq.py
runs it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, t
from vqvaehmm_tpu.ops import vq as jvq
from vqvaehmm_tpu_torch.ops import vq as tvq

ATOL = 1e-4


def _data(N=300, D=16, M=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, D)).astype(np.float32),
            (0.5 * rng.normal(size=(M, D))).astype(np.float32))


@pytest.mark.parametrize("N,D,M", [(300, 16, 8), (37, 5, 3), (1, 64, 40)])
def test_nearest_codes_and_lookup_match_jax(N, D, M):
    z, cb = _data(N, D, M, seed=N)
    idx = tvq.nearest_codes(t(z), t(cb))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jvq.nearest_codes(jnp.asarray(z),
                                                  jnp.asarray(cb))))
    # the brute-force definition: argmin of the squared distance
    d2 = ((z[:, None, :] - cb[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(idx.numpy(), d2.argmin(-1))

    zq, idx2 = tvq.vq_lookup(t(z), t(cb))
    jzq, jidx = jvq.vq_lookup(jnp.asarray(z), jnp.asarray(cb))
    pzq, pidx = jvq.vq_pallas(jnp.asarray(z), jnp.asarray(cb),
                              block_rows=128, interpret=True)
    for want_zq, want_idx in ((jzq, jidx), (pzq, pidx)):
        np.testing.assert_array_equal(idx2.numpy(), np.asarray(want_idx))
        close(zq, want_zq, ATOL)
    # z_q is the chosen rows, bit for bit
    assert torch.equal(zq, t(cb)[idx2.long()])


def test_layouts_agree_and_leading_dims_kept():
    rng = np.random.default_rng(3)
    z = rng.normal(size=(4, 9, 16)).astype(np.float32)       # (B, T, D)
    _, cb = _data(seed=3)
    zq, idx = tvq.vq_nearest(t(z), t(cb))
    assert zq.shape == (4, 9, 16) and idx.shape == (4, 9)
    zq_cf, idx_cf = tvq.vq_nearest(t(z).transpose(1, 2).contiguous(), t(cb),
                                   channels_first=True)
    assert zq_cf.shape == (4, 16, 9)
    assert torch.equal(idx, idx_cf)
    assert torch.equal(zq, zq_cf.transpose(1, 2))
    with pytest.raises(ValueError, match="channels_first"):
        tvq.vq_nearest(t(z[0]), t(cb), channels_first=True)
    with pytest.raises(ValueError, match="codebook"):
        tvq.vq_nearest(t(z), t(cb[:, :5]))


def test_duplicate_code_row_gives_the_lower_index():
    z, cb = _data(seed=4)
    cb[5] = cb[2]                                  # an exact tie
    idx = tvq.nearest_codes(t(z), t(cb)).numpy()
    jidx = np.asarray(jvq.nearest_codes(jnp.asarray(z), jnp.asarray(cb)))
    np.testing.assert_array_equal(idx, jidx)
    assert (idx == 2).any() and not (idx == 5).any()


@pytest.mark.parametrize("masked", [False, True])
def test_quantize_st_and_its_gradients_match_jax(masked):
    rng = np.random.default_rng(5)
    z = rng.normal(size=(3, 11, 8)).astype(np.float32)       # (B, T, D)
    cb = (0.5 * rng.normal(size=(6, 8))).astype(np.float32)
    mask = (np.arange(11)[None, :] < np.array([11, 4, 7])[:, None]) \
        if masked else None
    w = rng.normal(size=z.shape).astype(np.float32)          # a cotangent

    def jax_loss(z_, cb_):
        r = jvq.quantize_st(z_, cb_, 0.25, mask=None if mask is None
                            else jnp.asarray(mask))
        return ((r.quantized * w).sum() + r.commitment_loss
                + 2.0 * r.codebook_loss), r

    (jl, jr), (jgz, jgc) = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                              has_aux=True)(
        jnp.asarray(z), jnp.asarray(cb))

    for channels_first in (False, True):
        tz = t(z).clone().requires_grad_()
        tc = t(cb).clone().requires_grad_()
        zin = tz.transpose(1, 2) if channels_first else tz
        r = tvq.quantize_st(zin, tc, 0.25, channels_first=channels_first,
                            mask=None if mask is None else t(mask))
        q = r.quantized.transpose(1, 2) if channels_first else r.quantized
        loss = (q * t(w)).sum() + r.commitment_loss + 2.0 * r.codebook_loss
        loss.backward()
        np.testing.assert_array_equal(r.indices.numpy(),
                                      np.asarray(jr.indices))
        assert r.indices.dtype == torch.int32
        close(q.detach(), jr.quantized, ATOL)
        close(r.commitment_loss.detach(), jr.commitment_loss, ATOL)
        close(r.codebook_loss.detach(), jr.codebook_loss, ATOL)
        close(loss.detach(), jl, ATOL)
        close(tz.grad, jgz, ATOL, "d/dz_e")
        close(tc.grad, jgc, ATOL, "d/dcodebook")


def test_ema_update_matches_jax():
    rng = np.random.default_rng(6)
    z = rng.normal(size=(5, 7, 8)).astype(np.float32)
    cb = (0.5 * rng.normal(size=(6, 8))).astype(np.float32)
    idx = np.array(jvq.vq_lookup(jnp.asarray(z), jnp.asarray(cb))[1])
    jstate, tstate = jvq.ema_init(jnp.asarray(cb)), tvq.ema_init(t(cb))
    jcb, tcb = jnp.asarray(cb), t(cb)
    for _ in range(2):
        jstate, jcb = jvq.ema_update(jstate, jcb, jnp.asarray(z),
                                     jnp.asarray(idx), decay=0.9)
        tstate, tcb = tvq.ema_update(tstate, tcb, t(z), t(idx), decay=0.9)
    close(tstate.cluster_size, jstate.cluster_size, ATOL)
    close(tstate.cluster_sum, jstate.cluster_sum, ATOL)
    close(tcb, jcb, ATOL)


def test_cpu_paths_launch_nothing_and_the_gate():
    z, cb = _data(seed=7)
    before = tvq.vq_nearest.launches
    tvq.vq_nearest(t(z), t(cb))
    tvq.vq_nearest(t(z), t(cb), use_kernel=False)
    tvq.quantize_st(t(z), t(cb), use_kernel=False)
    assert tvq.vq_nearest.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tvq.vq_nearest(t(z), t(cb), use_kernel=True)
    assert tvq.vq_supported(8, 16, torch.float32, "cuda")
    assert tvq.vq_supported(64, 64, torch.float32, "cuda:0")
    assert not tvq.vq_supported(8, 16, torch.float32, "cpu")
    assert not tvq.vq_supported(8, 16, torch.float64, "cuda")
    assert not tvq.vq_supported(8, 65, torch.float32, "cuda")   # registers
    assert not tvq.vq_supported(400, 32, torch.float32, "cuda")  # 48 KB
