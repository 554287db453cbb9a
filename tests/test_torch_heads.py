"""The port's head trainers (vqvaehmm_tpu_torch/train/heads.py) against
the JAX package's from the same head parameters, VAE parameters and
batches: each epoch's loss within 1e-4 relative and the final parameters
within 1e-4."""

import jax
import numpy as np
import pytest
import torch

import vqvaehmm_tpu.train.heads as jheads
import vqvaehmm_tpu_torch.train.heads as theads
from tests.torch_port import model_pair
from vqvaehmm_tpu.models.hedging import LSTMDeltaHedger as JLSTMHedger
from vqvaehmm_tpu.models.hedging import RegimeDeltaHedger as JRegimeHedger
from vqvaehmm_tpu.models.portfolio import HeadConfig as JHeadConfig
from vqvaehmm_tpu.models.portfolio import \
    ImprovedPortfolioOptimizer as JImproved
from vqvaehmm_tpu.models.portfolio import \
    RegimePortfolioOptimizer as JRegimeHead
from vqvaehmm_tpu_torch.data.checkpoint import (
    improved_head_params_from_numpy, params_from_numpy,
    zoo_params_from_numpy)
from vqvaehmm_tpu_torch.models.hedging import (LSTMDeltaHedger,
                                               RegimeDeltaHedger)
from vqvaehmm_tpu_torch.models.portfolio import (HeadConfig,
                                                 ImprovedPortfolioOptimizer,
                                                 RegimePortfolioOptimizer)
from vqvaehmm_tpu_torch.ops.fused_encoder import fused_encode

A, H = 4, 8
HEADS = {
    "regime": (JRegimeHead, RegimePortfolioOptimizer, params_from_numpy),
    "improved": (JImproved, ImprovedPortfolioOptimizer,
                 improved_head_params_from_numpy),
}


@pytest.fixture(scope="module")
def vae():
    return model_pair(seed=1)


def _head(kind="regime", seed=0, n_assets=A):
    jcls, tcls, carry = HEADS[kind]
    jm = jcls(JHeadConfig(K=3, n_assets=n_assets, hidden_dim=H))
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(seed)))
    tm = tcls(HeadConfig(K=3, n_assets=n_assets, hidden_dim=H))
    tm.load_state_dict(carry(params))
    return jm, params, tm


def _batches(n=3, B=8, T=24, horizon=20, seed=0):
    rng = np.random.default_rng(seed)
    batches = [(rng.normal(size=(B, 5, T)).astype(np.float32),
                rng.normal(size=(B, 4, T)).astype(np.float32),
                np.full(B, T, np.int32)) for _ in range(n)]
    rets = [rng.normal(5e-4, 0.01, size=(B, horizon, A)).astype(np.float32)
            for _ in range(n)]
    return batches, rets


def _same_params(got, want_tree, carry):
    want = carry(jax.tree_util.tree_map(np.asarray, want_tree))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)


def _same_history(got, want):
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


@pytest.mark.parametrize("kind,use_scheduler", [("regime", True),
                                                ("improved", True),
                                                ("regime", False)])
def test_train_portfolio_matches_jax(vae, kind, use_scheduler):
    jvae, jparams, tvae = vae
    jm, hp, tm = _head(kind)
    batches, rets = _batches()
    want = jheads.train_portfolio(jm, hp, jvae, jparams, batches, rets,
                                  num_epochs=4, lr=0.01,
                                  use_scheduler=use_scheduler, log_fn=None)
    got = theads.train_portfolio(tm, tvae, batches, rets, num_epochs=4,
                                 lr=0.01, use_scheduler=use_scheduler,
                                 log_fn=None)
    _same_history(got.history, want.history)
    _same_params(got.params, want.params, HEADS[kind][2])


@pytest.mark.parametrize("kind", ["regime", "improved"])
def test_train_portfolio_fused_matches_jax_and_stepwise(vae, kind):
    jvae, jparams, tvae = vae
    jm, hp, tm = _head(kind, seed=2)
    batches, rets = _batches(seed=2)
    want = jheads.train_portfolio_fused(jm, hp, jvae, jparams, batches,
                                        rets, num_epochs=4, lr=0.01)
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    got = theads.train_portfolio_fused(tm, tvae, batches, rets,
                                       num_epochs=4, lr=0.01)
    _same_history(got.history, want.history)
    _same_params(got.params, want.params, HEADS[kind][2])
    tm.load_state_dict(start)
    step = theads.train_portfolio(tm, tvae, batches, rets, num_epochs=4,
                                  lr=0.01, log_fn=None)
    np.testing.assert_allclose(got.history, step.history, rtol=1e-5,
                               atol=1e-6)
    for k, v in step.params.items():
        np.testing.assert_allclose(got.params[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_train_portfolio_optimizer_matches_jax(vae):
    jvae, jparams, tvae = vae
    jm, hp, tm = _head(seed=3)
    batches, rets = _batches(seed=3)
    want = jheads.train_portfolio_optimizer(jm, hp, jvae, jparams, batches,
                                            rets, num_epochs=4, lr=0.01,
                                            log_fn=None)
    got = theads.train_portfolio_optimizer(tm, tvae, batches, rets,
                                           num_epochs=4, lr=0.01,
                                           log_fn=None)
    _same_history(got.history, want.history)
    _same_params(got.params, want.params, params_from_numpy)


@pytest.mark.parametrize("is_lstm", [False, True])
def test_train_delta_hedger_matches_jax(vae, is_lstm):
    """Pointwise (RegimeDeltaHedger on x[:, :, -1] and a position of ones)
    and the LSTM hedger on the whole x; n_assets is x's C."""
    jvae, jparams, tvae = vae
    cfg = dict(K=3, n_assets=5, hidden_dim=H)
    jcls, tcls = ((JLSTMHedger, LSTMDeltaHedger) if is_lstm
                  else (JRegimeHedger, RegimeDeltaHedger))
    jm = jcls(JHeadConfig(**cfg))
    hp = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    tm = tcls(HeadConfig(**cfg))
    tm.load_state_dict(zoo_params_from_numpy(hp, tm))
    batches, _ = _batches(n=2, B=4, T=16, seed=4)
    rng = np.random.default_rng(5)
    futures = [rng.normal(0, 0.01, size=(4, 15, 5)).astype(np.float32)
               for _ in range(2)]
    want = jheads.train_delta_hedger(jm, hp, jvae, jparams, batches, futures,
                                     num_epochs=3, lr=0.01, is_lstm=is_lstm,
                                     log_fn=None)
    got = theads.train_delta_hedger(tm, tvae, batches, futures,
                                    num_epochs=3, lr=0.01, is_lstm=is_lstm,
                                    log_fn=None)
    _same_history(got.history, want.history)
    _same_params(got.params, want.params,
                 lambda tree: zoo_params_from_numpy(tree, tm))


TRAINERS = ["train_portfolio", "train_portfolio_fused",
            "train_portfolio_optimizer", "train_delta_hedger"]


@pytest.mark.parametrize("trainer", TRAINERS)
def test_padded_batches_are_refused(vae, trainer):
    batches, rets = _batches(n=1)
    x, u, lengths = batches[0]
    lengths = lengths.copy()
    lengths[2] = 12
    with pytest.raises(ValueError, match="full windows"):
        _train_in_mode(trainer, vae[2], [(x, u, lengths)], rets, False)


@pytest.mark.parametrize("trainer", TRAINERS)
@pytest.mark.parametrize("training", [True, False])
def test_vae_frozen_mode_restored_no_launch_on_cpu(vae, trainer, training):
    """The VAE's parameters are unchanged, the trained module's mode is
    what it was, the module did move, and a CPU run launches no kernel."""
    tvae = vae[2]
    before = {k: v.clone() for k, v in tvae.state_dict().items()}
    launches = fused_encode.launches
    batches, rets = _batches(n=2)
    head, res = _train_in_mode(trainer, tvae, batches, rets, training)
    assert head.training is training
    for k, v in tvae.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert fused_encode.launches == launches
    assert len(res.history) == 2 and all(np.isfinite(res.history))


def _train_in_mode(trainer, vae, batches, rets, training):
    if trainer == "train_delta_hedger":
        head = RegimeDeltaHedger(HeadConfig(K=3, n_assets=5, hidden_dim=H))
        futs = [np.full((x.shape[0], x.shape[2] - 1, 5), 0.01, np.float32)
                for x, _, _ in batches]
        args = (futs,)
    else:
        head = RegimePortfolioOptimizer(HeadConfig(K=3, n_assets=A,
                                                   hidden_dim=H))
        args = (rets,)
    head.train(training)
    start = {k: v.clone() for k, v in head.state_dict().items()}
    kw = {} if trainer == "train_portfolio_fused" else {"log_fn": None}
    res = getattr(theads, trainer)(head, vae, batches, *args, num_epochs=2,
                                   lr=0.01, **kw)
    assert any(not torch.equal(v, start[k]) for k, v in res.params.items())
    return head, res


def test_fused_needs_a_batch(vae):
    head = RegimePortfolioOptimizer(HeadConfig(K=3, n_assets=A,
                                               hidden_dim=H))
    with pytest.raises(ValueError, match=">= 1 batch"):
        theads.train_portfolio_fused(head, vae[2], [], [], num_epochs=1)
