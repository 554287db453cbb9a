"""The port's losses (vqvaehmm_tpu_torch/losses/portfolio.py) against the
JAX package's on the same numpy inputs: every value within 1e-5, and the
gradients that the head trainers and the adversarial loss take within
1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqvaehmm_tpu.losses.portfolio as jl
import vqvaehmm_tpu_torch.losses.portfolio as tl
from tests.torch_port import t
from vqvaehmm_tpu.models.portfolio import HeadConfig as JHeadConfig
from vqvaehmm_tpu.models.portfolio import \
    RegimePortfolioOptimizer as JRegimeHead
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
from vqvaehmm_tpu_torch.models.portfolio import (HeadConfig,
                                                 RegimePortfolioOptimizer)

TOL = 1e-5


def _near(got, want, tol=TOL, what=""):
    """|got - want| <= tol * max(1, |want|), elementwise."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = tol * np.maximum(1.0, np.abs(want))
    assert np.all(np.abs(got - want) <= bound), \
        f"{what}: max diff {np.abs(got - want).max():.3e}"


def _data(T=24, B=6, A=4, K=3, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.dirichlet(np.ones(A), size=B).astype(np.float32)
    prev = rng.dirichlet(np.ones(A), size=B).astype(np.float32)
    r = rng.normal(5e-4, 0.01, size=(B, T, A)).astype(np.float32)
    q_btk = rng.dirichlet(np.ones(K), size=(B, T)).astype(np.float32)
    Amat = rng.dirichlet(np.ones(K), size=(B, T, K)).astype(np.float32)
    cov = np.einsum("bta,btc->bac", r, r).astype(np.float32) / T
    return dict(w=w, prev=prev, r=r, q_btk=q_btk,
                q_kt=np.ascontiguousarray(np.transpose(q_btk, (0, 2, 1))),
                Amat=Amat, cov=cov, K=K)


# (name, function name, argument keys, extra keyword arguments)
CASES = [
    ("sharpe", "sharpe_loss", ("w", "r"), {}),
    ("sharpe_rf", "sharpe_loss", ("w", "r"), {"rf": 1e-4}),
    ("sortino", "sortino_loss", ("w", "r"), {"target_return": 1e-4}),
    ("calmar", "calmar_loss", ("w", "r"), {}),
    ("portfolio", "portfolio_loss", ("w", "r"), {}),
    ("portfolio_prev", "portfolio_loss", ("w", "r", "prev"), {}),
    ("portfolio_unused_args", "portfolio_loss", ("w", "r", "prev", "q_kt",
                                                 "cov"), {}),
    ("risk_parity", "risk_parity_loss", ("w", "r"), {}),
    ("risk_parity_cov", "risk_parity_loss", ("w", "r", "cov"), {}),
    ("regime_conditional_bkt", "regime_conditional_loss",
     ("w", "r", "q_kt"), {"K": 3}),
    ("regime_conditional_btk", "regime_conditional_loss",
     ("w", "r", "q_btk"), {"K": 3}),
    ("transition_aware_bkt", "transition_aware_loss",
     ("w", "r", "q_kt", "Amat"), {}),
    ("transition_aware_btk", "transition_aware_loss",
     ("w", "r", "q_btk", "Amat"), {"lookahead": 3}),
    ("regime_aware_sharpe", "regime_aware_sharpe_loss",
     ("w", "r", "q_btk", "Amat"), {}),
    ("regime_aware_sharpe_bkt_3d", "regime_aware_sharpe_loss",
     ("w", "r", "q_kt", "Amat_last"), {"rf": 1e-4}),
]


def _args(d, keys):
    d = dict(d, Amat_last=d["Amat"][:, -1])
    return [d[k] for k in keys]


@pytest.mark.parametrize("T", [24, 12])
@pytest.mark.parametrize("name,fn,keys,kw", CASES, ids=[c[0] for c in CASES])
def test_loss_values_match_jax(name, fn, keys, kw, T):
    """T=24 takes one CVaR return (int(0.05 T) = 1); T=12 none, where the
    CVaR term is a float32 zero."""
    args = _args(_data(T=T), keys)
    want = float(getattr(jl, fn)(*map(jnp.asarray, args), **kw))
    got = getattr(tl, fn)(*map(t, args), **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    _near(got.item(), want, what=name)


@pytest.mark.parametrize("name,fn,keys", [
    ("sharpe", "sharpe_loss", ("w", "r")),
    ("portfolio", "portfolio_loss", ("w", "r")),
    ("portfolio_prev", "portfolio_loss", ("w", "r", "prev")),
    ("calmar", "calmar_loss", ("w", "r"))])
def test_loss_gradients_match_jax(name, fn, keys):
    """The gradient with respect to the weights (what the head trainers
    backpropagate): through the sort of the CVaR, the running maximum of
    the drawdown and the turnover."""
    args = _args(_data(), keys)
    want = np.asarray(jax.grad(lambda w: getattr(jl, fn)(
        w, *map(jnp.asarray, args[1:])))(jnp.asarray(args[0])))
    w = t(args[0]).clone().requires_grad_(True)
    getattr(tl, fn)(w, *map(t, args[1:])).backward()
    _near(w.grad.numpy(), want, what=name)


def _hedge_data(B=5, T=30, A=4, K=3, seed=1):
    rng = np.random.default_rng(seed)
    return dict(
        h=rng.normal(-0.5, 0.3, size=(B, A)).astype(np.float32),
        spot=rng.normal(0, 0.01, size=(B, T, A)).astype(np.float32),
        fut=rng.normal(0, 0.01, size=(B, T, A)).astype(np.float32),
        cost=rng.uniform(0, 0.01, size=(B, A)).astype(np.float32),
        q=rng.dirichlet(np.ones(K), size=(B, T)).astype(np.float32))


@pytest.mark.parametrize("with_cost", [False, True])
def test_delta_hedge_loss_and_gradient(with_cost):
    d = _hedge_data()
    extra = (d["cost"],) if with_cost else ()
    jf = jax.value_and_grad(lambda h: jl.delta_hedge_loss(
        h, jnp.asarray(d["spot"]), jnp.asarray(d["fut"]),
        *map(jnp.asarray, extra)))
    want, want_g = jf(jnp.asarray(d["h"]))
    h = t(d["h"]).clone().requires_grad_(True)
    got = tl.delta_hedge_loss(h, t(d["spot"]), t(d["fut"]), *map(t, extra))
    got.backward()
    _near(got.item(), float(want), what="delta_hedge_loss")
    _near(h.grad.numpy(), np.asarray(want_g), what="its gradient")


@pytest.mark.parametrize("layout", ["none", "btk", "bkt"])
def test_minimum_variance_hedge_ratio(layout):
    d = _hedge_data()
    if layout == "none":
        extra, kw = (), {}
    else:
        q = d["q"] if layout == "btk" else np.ascontiguousarray(
            np.transpose(d["q"], (0, 2, 1)))
        extra, kw = (q,), {"K": 3}
    want = jl.minimum_variance_hedge_ratio(
        jnp.asarray(d["spot"]), jnp.asarray(d["fut"]),
        *map(jnp.asarray, extra), **kw)
    got = tl.minimum_variance_hedge_ratio(t(d["spot"]), t(d["fut"]),
                                          *map(t, extra), **kw)
    _near(got.numpy(), np.asarray(want), what=layout)


def test_optimal_hedge_frequency():
    vol = np.array([0.0, 0.01, 0.2, 0.5], np.float32)
    pers = np.array([0.5, 1.0, 3.0, 20.0], np.float32)
    for tx in (0.001, 0.01):
        want = jl.optimal_hedge_frequency(jnp.asarray(vol), tx,
                                          jnp.asarray(pers))
        got = tl.optimal_hedge_frequency(t(vol), tx, t(pers))
        _near(got.numpy(), np.asarray(want), what=f"tx {tx}")
    _near(tl.optimal_hedge_frequency(0.2, 0.001, 4.0).item(),
          float(jl.optimal_hedge_frequency(0.2, 0.001, 4.0)), what="floats")


def test_adversarial_loss_and_head_gradient():
    """FGSM on the regime probabilities through a head: the loss, and its
    gradient with respect to every parameter of the head (through the
    gradient taken with create_graph)."""
    cfg = JHeadConfig(K=3, n_assets=4, hidden_dim=8)
    jhead = JRegimeHead(cfg)
    params = jhead.init(jax.random.PRNGKey(3))
    head = RegimePortfolioOptimizer(HeadConfig(K=3, n_assets=4,
                                               hidden_dim=8))
    head.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    d = _data()
    q = d["q_btk"][:, -1]                                       # (B, K)
    want, want_g = jax.value_and_grad(lambda p: jl.adversarial_portfolio_loss(
        lambda rp: jhead(p, rp), jnp.asarray(q), jnp.asarray(d["r"]),
        epsilon=0.05))(params)
    got = tl.adversarial_portfolio_loss(head, t(q), t(d["r"]), epsilon=0.05)
    got.backward()
    _near(got.item(), float(want), what="loss")
    want_sd = params_from_numpy(jax.tree_util.tree_map(np.asarray, want_g))
    for name, p in head.named_parameters():
        _near(p.grad.numpy(), want_sd[name].numpy(), what=name)
