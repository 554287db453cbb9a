"""The port's fused loss-and-gradients (vqvaehmm_tpu_torch/ops/fused_train.py)
against the JAX package: on the CPU the port computes its plain version
(compute_loss plus autograd), held against JAX's Pallas train kernel in
interpret mode and against jax.value_and_grad(compute_loss), with the
bars of tests/test_pallas_train.py (loss rtol 5e-5; each gradient rtol
1e-4 plus 5e-5 of its largest entry)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import inputs, model_pair, t
from vqvaehmm_tpu.ops.pallas_train import fused_loss_and_grads as jax_fused
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
from vqvaehmm_tpu_torch.ops.fused_train import (FusedELBO, PARAM_NAMES,
                                                fused_loss_and_grads,
                                                train_step_supported)


def _as_state_dict(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _close_grads(got, want):
    assert set(got) == set(want) == set(PARAM_NAMES)
    for name, w in want.items():
        a, b = w.numpy(), got[name].detach().numpy()
        assert a.shape == b.shape, name
        np.testing.assert_allclose(
            b, a, rtol=1e-4, atol=5e-5 * max(np.max(np.abs(a)), 1e-12),
            err_msg=name)


@pytest.mark.parametrize("beta,short,layout", [
    (1.0, None, "BUT"), (0.7, None, "BUT"), (1.0, 29, "BTU")])
def test_fused_loss_and_grads_match_jax(beta, short, layout):
    jm, params, tm = model_pair(seed=3)
    x, u, lengths = inputs(8, 48, seed=int(beta * 10) + (short or 0))
    if short is not None:
        lengths = np.minimum(lengths, short)       # valid_to inside T
    if layout == "BTU":
        u = np.ascontiguousarray(u.transpose(0, 2, 1))
    loss, grads = fused_loss_and_grads(tm, t(x), t(u), t(lengths), beta)
    args = (params, jnp.asarray(x), jnp.asarray(u), jnp.asarray(lengths),
            beta)
    ref_loss, ref_grads = jax.value_and_grad(jm.compute_loss)(*args)
    k_loss, k_grads = jax_fused(jm, *args, interpret=True)
    for want_loss, want in ((ref_loss, ref_grads), (k_loss, k_grads)):
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=5e-5)
        _close_grads(grads, _as_state_dict(want))


def test_fused_elbo_backward_fills_grad():
    _, _, tm = model_pair(seed=5)
    x, u, lengths = (t(a) for a in inputs(4, 24, seed=6))
    params = [p for _, p in tm.named_parameters()]
    loss = FusedELBO.apply(tm, x, u, lengths, 0.6, *params)
    (loss * 2.0).backward()
    got = {n: p.grad.clone() for n, p in tm.named_parameters()}
    tm.zero_grad()
    want_loss = tm.compute_loss(x, u, lengths, 0.6)
    (want_loss * 2.0).backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()),
                                                 rel=1e-6)
    _close_grads(got, {n: p.grad for n, p in tm.named_parameters()})


def test_fused_loss_and_grads_dispatch():
    _, _, tm = model_pair(seed=7)
    x, u, lengths = (t(a) for a in inputs(2, 16, seed=8))
    before = fused_loss_and_grads.launches
    fused_loss_and_grads(tm, x, u, lengths, 1.0)      # CPU: plain version
    assert fused_loss_and_grads.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        fused_loss_and_grads(tm, x, u, lengths, 1.0, use_kernel=True)
    cfg = tm.cfg
    assert train_step_supported(cfg, 64, 200)
    assert not train_step_supported(
        type(cfg)(**{**cfg.__dict__, "K": 17}), 64, 200)
    assert not train_step_supported(
        type(cfg)(**{**cfg.__dict__, "compute_dtype": "bfloat16"}), 64, 200)
    assert not train_step_supported(cfg, 64, 2 ** 30)
