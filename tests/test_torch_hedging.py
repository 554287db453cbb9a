"""The port's hedgers (vqvaehmm_tpu_torch/models/hedging.py) against the
JAX package's with the same weights, carried across by
data/checkpoint.py::zoo_params_from_numpy: outputs within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vqvaehmm_tpu.models.hedging as jh
import vqvaehmm_tpu_torch.models.hedging as th
from tests.torch_port import close, t
from vqvaehmm_tpu.models.portfolio import HeadConfig as JHeadConfig
from vqvaehmm_tpu_torch.data.checkpoint import zoo_params_from_numpy
from vqvaehmm_tpu_torch.models.portfolio import HeadConfig

B, K, A, H = 4, 3, 5, 8


def _pair(name, seed=0, **kw):
    jm = getattr(jh, name)(JHeadConfig(K=K, n_assets=A, hidden_dim=H), **kw)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(seed)))
    tm = getattr(th, name)(HeadConfig(K=K, n_assets=A, hidden_dim=H), **kw)
    tm.load_state_dict(zoo_params_from_numpy(params, tm))
    return jm, params, tm.eval()


def _inputs(T=12, seed=0):
    rng = np.random.default_rng(seed)
    q = np.transpose(rng.dirichlet(np.ones(K), size=(B, T)),
                     (0, 2, 1)).astype(np.float32)                # (B, K, T)
    vec = [rng.normal(size=(B, A)).astype(np.float32) for _ in range(4)]
    trans = rng.dirichlet(np.ones(K), size=(B, T, K)).astype(np.float32)
    return q, vec, trans


def _check(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        close(g.detach().numpy(), np.asarray(w), 1e-5)


@pytest.mark.parametrize("q_rank", [2, 3])
def test_regime_delta_hedger(q_rank):
    jm, p, tm = _pair("RegimeDeltaHedger")
    q, (spot, pos, _, _), _ = _inputs()
    q = q if q_rank == 3 else q[:, :, -1]
    _check(tm(t(q), t(spot), t(pos)),
           jm(p, jnp.asarray(q), jnp.asarray(spot), jnp.asarray(pos)))


@pytest.mark.parametrize("use_gamma", [True, False])
def test_dynamic_delta_hedger(use_gamma):
    jm, p, tm = _pair("DynamicDeltaHedger", seed=1, use_gamma=use_gamma)
    q, (spot, pos, gamma, _), _ = _inputs()
    extra = (gamma,) if use_gamma else ()
    _check(tm(t(q), t(spot), t(pos), *map(t, extra)),
           jm(p, jnp.asarray(q), jnp.asarray(spot), jnp.asarray(pos),
              *map(jnp.asarray, extra)))
    # the hedger carries no dropout: training mode gives the same numbers
    _check(tm.train()(t(q), t(spot), t(pos), *map(t, extra)),
           jm(p, jnp.asarray(q), jnp.asarray(spot), jnp.asarray(pos),
              *map(jnp.asarray, extra)))


def test_dynamic_delta_hedger_requires_gamma():
    _, _, tm = _pair("DynamicDeltaHedger")
    q, (spot, pos, _, _), _ = _inputs()
    with pytest.raises(ValueError, match="requires gamma"):
        tm(t(q), t(spot), t(pos))


@pytest.mark.parametrize("T,layout", [(12, "channels_first"),
                                      (12, "time_major"),
                                      (A, "square")])
def test_lstm_delta_hedger(T, layout):
    """Prices channels-first (B, C, T), time-major (B, T, C), and the square
    C == T case, which both packages read channels-first."""
    jm, p, tm = _pair("LSTMDeltaHedger", seed=2)
    rng = np.random.default_rng(T)
    q, _, _ = _inputs(T)
    prices = rng.normal(size=(B, A, T)).astype(np.float32)
    if layout == "time_major":
        prices = np.ascontiguousarray(np.transpose(prices, (0, 2, 1)))
    _check(tm(t(q), t(prices)), jm(p, jnp.asarray(q), jnp.asarray(prices)))
    # the regime path may come (B, T, K) too
    q_btk = np.ascontiguousarray(np.transpose(q, (0, 2, 1)))
    _check(tm(t(q_btk), t(prices)),
           jm(p, jnp.asarray(q_btk), jnp.asarray(prices)))


def test_transaction_cost_aware_hedger():
    jm, p, tm = _pair("TransactionCostAwareHedger", seed=3, tx_cost=0.002)
    q, (hedge, target, spot, _), _ = _inputs()
    hedge = 0.05 * hedge                # some deviations under the threshold
    _check(tm(t(q), t(hedge), t(target), t(spot)),
           jm(p, jnp.asarray(q), jnp.asarray(hedge), jnp.asarray(target),
              jnp.asarray(spot)))


@pytest.mark.parametrize("lookahead", [1, 5])
def test_transition_aware_hedger(lookahead):
    jm, p, tm = _pair("TransitionAwareHedger", seed=4, lookahead=lookahead)
    q, (spot, _, _, _), trans = _inputs()
    _check(tm(t(q), t(trans), t(spot)),
           jm(p, jnp.asarray(q), jnp.asarray(trans), jnp.asarray(spot)))


def test_hedger_params_checked_against_the_module():
    _, params, _ = _pair("RegimeDeltaHedger")
    wrong = th.DynamicDeltaHedger(HeadConfig(K=K, n_assets=A, hidden_dim=H))
    with pytest.raises(ValueError, match="do not match"):
        zoo_params_from_numpy(params, wrong)
