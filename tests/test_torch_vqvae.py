"""The port's VQ-VAE (vqvaehmm_tpu_torch/models/vqvae_hmm.py) on the CPU
against the JAX package's models/vqvae_hmm.py with one shared parameter
set and the same numpy inputs: reals and all 13 gradients to <= 1e-4
(float32, other summation orders), codes and counts equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, t
from vqvaehmm_tpu.models import vqvae_hmm as jvq
from vqvaehmm_tpu_torch.data.checkpoint import (VQ_LEAF_ORDER,
                                                vq_params_from_numpy,
                                                vq_params_to_numpy)
from vqvaehmm_tpu_torch.models import hmm as thmm
from vqvaehmm_tpu_torch.models.vqvae_hmm import VQVAEConfig, VQVAEHMM
from vqvaehmm_tpu_torch.ops.vq import vq_nearest

ATOL = 1e-4
SMALL = dict(input_dim=5, hidden_dim=8, hidden_dim2=4, num_codes=6,
             latent_dim=4)


def _pair(seed=0):
    """(jax model, jax params, torch model) sharing one parameter set."""
    jm = jvq.VQVAEHMM(jvq.VQVAEConfig(**SMALL))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = VQVAEHMM(VQVAEConfig(**SMALL))
    tm.load_state_dict(vq_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _inputs(B=4, T=21, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 5, T)).astype(np.float32)
    lengths = np.array([T, 6, 15, 11][:B], np.int32)
    return x, lengths


def test_parameters_cross_in_the_archive_order():
    _, params, tm = _pair()
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(params)]
    sd = tm.state_dict()
    assert list(sd) != list(VQ_LEAF_ORDER)        # module order differs
    for key, leaf in zip(VQ_LEAF_ORDER, leaves):
        np.testing.assert_array_equal(sd[key].numpy(), leaf, err_msg=key)
    # the flat list and the nested tree give the same state_dict
    flat = vq_params_from_numpy(leaves)
    assert all(torch.equal(flat[k], sd[k]) for k in VQ_LEAF_ORDER)
    back = jax.tree_util.tree_leaves(vq_params_to_numpy(sd))
    for a, b in zip(back, leaves):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="13"):
        vq_params_from_numpy(leaves[:-1])
    with pytest.raises(KeyError, match="VQVAEHMM"):
        vq_params_from_numpy({"codebook": leaves[0]})


def test_encode_codes_and_decode_match_jax():
    jm, params, tm = _pair()
    x, _ = _inputs()
    with torch.no_grad():
        z_e = tm.encode(t(x))
        close(z_e, jm.encode(params, jnp.asarray(x)), ATOL)
        before = vq_nearest.launches
        codes = tm.codes(t(x))
        assert vq_nearest.launches == before      # a CPU tensor: plain
        np.testing.assert_array_equal(
            codes.numpy(), np.asarray(jm.codes(params, jnp.asarray(x))))
        assert codes.dtype == torch.int32 and codes.shape == (4, 21)
        close(tm.decode(z_e), jm.decode(params, jnp.asarray(z_e.numpy())),
              ATOL)
        res = tm.quantize(z_e)
        want = jm.quantize(params, jnp.asarray(z_e.numpy()))
        close(res.quantized, want.quantized, ATOL)
        np.testing.assert_array_equal(res.indices.numpy(),
                                      np.asarray(want.indices))


@pytest.mark.parametrize("ragged", [False, True])
def test_compute_loss_and_all_gradients_match_jax(ragged):
    jm, params, tm = _pair(seed=2)
    x, lengths = _inputs(seed=3)
    jl = jnp.asarray(lengths) if ragged else None
    tl = t(lengths) if ragged else None

    def loss_fn(p):
        parts = jm.compute_loss(p, jnp.asarray(x), jl)
        return parts.total, parts

    (_, want), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    got = tm.compute_loss(t(x), tl)
    got.total.backward()
    for name in ("total", "recon", "commitment", "codebook"):
        close(getattr(got, name).detach(), getattr(want, name), ATOL, name)
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    assert int(got.counts.sum()) == (int(lengths.sum()) if ragged
                                     else x.shape[0] * x.shape[2])
    leaves = jax.tree_util.tree_leaves(grads)
    named = dict(tm.named_parameters())
    assert len(leaves) == len(named) == 13
    for key, g in zip(VQ_LEAF_ORDER, leaves):
        close(named[key].grad, g, ATOL, key)


def test_fit_hmm_and_sample():
    _, _, tm = _pair(seed=4)
    x, lengths = _inputs(B=4, T=21, seed=5)
    em = tm.fit_hmm(t(x), t(lengths), n_iters=3, seed=0)
    assert em.model.K == SMALL["num_codes"]
    assert torch.isfinite(em.log_likelihoods).all()
    out = tm.sample(em.model, torch.Generator().manual_seed(0), seq_len=9,
                    batch=3)
    assert out.shape == (3, 5, 9) and torch.isfinite(out).all()
    # a bare chain: its states are the codes
    bare = thmm.HiddenMarkovModel(np.full(6, 1 / 6), np.full((6, 6), 1 / 6),
                                  None)
    assert tm.sample(bare, torch.Generator().manual_seed(1), 7).shape \
        == (1, 5, 7)
    gauss = thmm.HiddenMarkovModel(
        np.full(6, 1 / 6), np.full((6, 6), 1 / 6),
        thmm.GaussianEmission(torch.zeros(6), torch.ones(6)))
    with pytest.raises(ValueError, match="categorical"):
        tm.sample(gauss, torch.Generator().manual_seed(2), 7)


@pytest.mark.parametrize("k,I,O", [(1, 4, 6), (3, 5, 8), (5, 2, 3)])
def test_matmul_convolution_is_the_convolution(k, I, O):
    """ops/nn.py::conv1d_same_matmul against conv1d_same and the JAX
    package's impl="matmul", values and gradients to <= 1e-5 (float32,
    other summation orders)."""
    from vqvaehmm_tpu.ops import nn as jnn
    from vqvaehmm_tpu_torch.ops import nn as tnn

    rng = np.random.default_rng(k)
    w = rng.normal(size=(O, I, k)).astype(np.float32)
    b = rng.normal(size=(O,)).astype(np.float32)
    x = rng.normal(size=(3, I, 17)).astype(np.float32)
    want = jnn.conv1d_same({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                           jnp.asarray(x), impl="matmul")
    grads = []
    for fn in (tnn.conv1d_same_matmul, tnn.conv1d_same):
        tw, tb, tx = (t(a).clone().requires_grad_() for a in (w, b, x))
        y = fn(tw, tb, tx)
        close(y.detach(), want, 1e-5)
        (y * y).sum().backward()
        grads.append((tw.grad, tb.grad, tx.grad))
    for g, h in zip(*grads):
        close(g, h, 1e-4 * float(h.abs().max()))
    with pytest.raises(ValueError, match="odd"):
        tnn.conv1d_same_matmul(t(w[:, :, :1].repeat(2, 2)), t(b), t(x))


def test_init_from_a_generator():
    a = VQVAEHMM(VQVAEConfig(**SMALL),
                 generator=torch.Generator().manual_seed(3))
    b = VQVAEHMM(VQVAEConfig(**SMALL),
                 generator=torch.Generator().manual_seed(3))
    c = VQVAEHMM(VQVAEConfig(**SMALL),
                 generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.codebook, c.codebook)
    # N(0, 0.5^2) codes; kaiming-uniform convolutions within their bound
    assert 0.2 < float(a.codebook.detach().std()) < 0.9
    bound = (1.0 / (5 * 3)) ** 0.5
    assert float(a.encoder.conv1.weight.detach().abs().max()) <= bound
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
