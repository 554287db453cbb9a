"""The port's Monte Carlo stage (vqvaehmm_tpu_torch/backtest/montecarlo.py)
against the JAX package's: the statistics bit for bit, the paths on JAX's
own draws within 1e-5 relative."""

import warnings

import jax
import numpy as np
import pytest
import torch

import vqvaehmm_tpu.backtest.montecarlo as jmc
import vqvaehmm_tpu_torch.backtest.montecarlo as tmc
from tests.torch_port import jax_mc_draws, t
from vqvaehmm_tpu.models.portfolio import HeadConfig as JHeadConfig
from vqvaehmm_tpu.models.portfolio import \
    ImprovedPortfolioOptimizer as JImproved
from vqvaehmm_tpu_torch.data.checkpoint import \
    improved_head_params_from_numpy
from vqvaehmm_tpu_torch.models.portfolio import (HeadConfig,
                                                 ImprovedPortfolioOptimizer)

K, A = 3, 4
N_SIM, N_DAYS = 64, 40
KW = dict(rebalance_every=5, switch_prob=0.3, tx_cost=0.002,
          initial_value=1.5)


def _returns(seed=0, T=300, rare=None):
    rng = np.random.default_rng(seed)
    rets = rng.normal(3e-4, 0.01, size=(T, A)).astype(np.float32)
    regimes = rng.integers(0, K, size=T)
    if rare is not None:                 # a regime with too few days
        regimes[regimes == rare] = (rare + 1) % K
        regimes[:3] = rare
    return rets, regimes


@pytest.mark.parametrize("rare", [None, 2])
def test_regime_statistics_bit_equal(rare):
    rets, regimes = _returns(rare=rare)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jmc.regime_statistics(rets, regimes, K)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tmc.regime_statistics(rets, regimes, K)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert len(tw) == (rare is not None)


def _heads(seed=0):
    jm = JImproved(JHeadConfig(K=K, n_assets=A, hidden_dim=8))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = ImprovedPortfolioOptimizer(HeadConfig(K=K, n_assets=A,
                                               hidden_dim=8))
    tm.load_state_dict(improved_head_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return (lambda oh: jm(params, oh[None])[0]), tm.eval()


def _jax_run(p0=None, seed=1):
    rets, regimes = _returns(seed)
    means, covs = jmc.regime_statistics(rets, regimes, K)
    jw, head = _heads(seed)
    key = jax.random.PRNGKey(seed)
    want = jmc.monte_carlo_simulation(jw, means, covs, key, n_sim=N_SIM,
                                      n_days=N_DAYS, p0=p0, **KW)
    draws = jax_mc_draws(key, K, A, N_SIM, N_DAYS, p0)
    return want, draws, means, covs, head


def _same_paths(got, want):
    """Within 1e-5 relative.  A daily return is value / prev - 1 in
    float32, so a return near 0 also carries the rounding of a ratio near
    1: two float32 roundings at 1.0 (2.4e-7) absolute are allowed there."""
    for key, atol in (("final_values", 0.0), ("daily_returns", 2.4e-7)):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=atol, err_msg=key)
    assert got["initial_value"] == want["initial_value"]


@pytest.mark.parametrize("p0", [None, [0.2, 0.5, 0.3]])
def test_simulate_paths_on_jax_draws(p0):
    """simulate_paths handed the draws JAX's simulation made: the same
    paths, with regime switches at a rebalance every 5 days."""
    want, draws, means, covs, head = _jax_run(p0)
    on_rebalance = draws["u_switch"][:, ::KW["rebalance_every"]]
    assert (on_rebalance < KW["switch_prob"]).sum() > N_SIM
    with torch.no_grad():
        weights = torch.stack([head(torch.eye(K)[k][None])[0]
                               for k in range(K)])
    chols = t(np.linalg.cholesky(covs).astype(np.float32))
    got = tmc.simulate_paths(weights, t(means.astype(np.float32)), chols,
                             **{k: t(v) for k, v in draws.items()}, **KW)
    _same_paths(got, want)


def test_monte_carlo_simulation_on_jax_draws(monkeypatch):
    """The whole simulation (weights from the head, the Cholesky factors
    in float64) with monte_carlo_draws swapped for JAX's draws."""
    want, draws, means, covs, head = _jax_run(seed=2)
    seen = []

    def fake(generator, k, a, n_sim, n_days, p0=None):
        seen.append((k, a, n_sim, n_days))
        return {key: t(v) for key, v in draws.items()}

    monkeypatch.setattr(tmc, "monte_carlo_draws", fake)
    got = tmc.monte_carlo_simulation(
        lambda oh: head(oh[None])[0], means, covs, torch.Generator(),
        n_sim=N_SIM, n_days=N_DAYS, device="cpu", **KW)
    assert seen == [(K, A, N_SIM, N_DAYS)]
    _same_paths(got, want)
    assert tmc.analyze_monte_carlo(got) == pytest.approx(
        jmc.analyze_monte_carlo(want), rel=1e-5, abs=1e-6)


def test_analyze_monte_carlo_equal_on_the_same_arrays():
    want, _, _, _, _ = _jax_run(seed=3)
    arrays = {k: np.array(v) for k, v in want.items()
              if k != "initial_value"}
    got = tmc.analyze_monte_carlo(
        {**{k: t(v) for k, v in arrays.items()}, "initial_value": 1.5})
    assert got == jmc.analyze_monte_carlo(want)
    assert got == tmc.analyze_monte_carlo(arrays, initial_value=1.5)


def test_same_seed_same_paths():
    _, _, means, covs, head = _jax_run(seed=4)

    def run(seed):
        return tmc.monte_carlo_simulation(
            lambda oh: head(oh[None])[0], means, covs,
            torch.Generator().manual_seed(seed), n_sim=N_SIM, n_days=N_DAYS,
            device="cpu", **KW)

    a, b, c = run(0), run(0), run(1)
    assert torch.equal(a["final_values"], b["final_values"])
    assert torch.equal(a["daily_returns"], b["daily_returns"])
    assert not torch.equal(a["final_values"], c["final_values"])
    equity = np.cumprod(1 + a["daily_returns"].numpy().astype(np.float64),
                        axis=1)[:, -1] * 1.5
    np.testing.assert_allclose(equity, a["final_values"].numpy(), rtol=1e-5)


def test_draws_come_from_the_generator():
    g = torch.Generator().manual_seed(5)
    d = tmc.monte_carlo_draws(g, K, A, 10, 7, p0=[0.0, 1.0, 0.0])
    assert d["z0"].tolist() == [1] * 10
    assert d["u_switch"].shape == (10, 7) and d["z_new"].shape == (10, 7)
    assert d["eps"].shape == (10, 7, A)
    assert int(d["z_new"].min()) >= 0 and int(d["z_new"].max()) < K
