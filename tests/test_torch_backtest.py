"""The port's backtester (vqvaehmm_tpu_torch/backtest) against the JAX
package's.

With the same `posterior_fn` / `model_fn` outputs (numpy closures that
both packages can call) the two ledgers are the same float64 arithmetic,
so every BacktestResult array agrees within 1e-9.  End to end on the
fixture panel, with the quality checkpoint and the Improved head loaded
into both packages, the posteriors differ by float32 rounding and every
metric agrees within 1e-4 relative."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vqvaehmm_tpu.backtest import backtester as jax_bt
from vqvaehmm_tpu_torch.backtest import (Backtester, BacktestResult,
                                         RegimeBacktest, WalkForwardBacktest,
                                         compare_strategies, plot_results)
from vqvaehmm_tpu_torch.data import market
from vqvaehmm_tpu_torch.data.checkpoint import (load_improved_head,
                                                load_params_npz,
                                                params_from_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, A = 3, 4


def _panel(T, seed):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(1, 5, T))
    prices = 100.0 * np.exp(np.cumsum(0.01 * rng.normal(size=(T, A)), 0))
    returns = np.vstack([np.zeros((1, A)), np.diff(prices, axis=0)
                         / prices[:-1]])
    return data, prices, returns


def _closures(seed, long_short=False):
    """posterior_fn and model_fn in numpy, callable from both packages.
    They compute in float64, so that the rounding of their sums (which
    numpy picks by the alignment of the buffer it is handed) stays far
    below the 1e-9 the ledgers are held to."""
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(K, 5))
    W = rng.normal(size=(K, A))

    def posterior_fn(x):
        x = np.asarray(x)
        assert x.dtype == np.float32 and x.ndim == 3
        z = np.einsum("kc,bct->bkt", P, x.astype(np.float64))
        e = np.exp(z - z.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    def model_fn(q):
        z = np.asarray(q)[:, :, -1] @ W
        if long_short:               # gross exposure far above 1
            return 3.0 * z
        e = np.exp(z - z.max(1, keepdims=True))
        return 1.7 * e / e.sum(1, keepdims=True)   # net sum above 1

    return posterior_fn, model_fn


def _same(got: BacktestResult, want, atol=1e-9):
    for name in ("returns", "positions", "trades", "equity_curve",
                 "drawdowns"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=atol, err_msg=name)
    assert got.metrics.keys() == want.metrics.keys()
    for k, v in want.metrics.items():
        assert abs(got.metrics[k] - v) <= atol * max(1.0, abs(v)), k
    assert len(got.trade_log) == len(want.trade_log)
    for g, w in zip(got.trade_log, want.trade_log):
        assert g["t"] == w["t"]
        np.testing.assert_allclose(
            [g["trade_value"], g["cost"], *g["weights"]],
            [w["trade_value"], w["cost"], *w["weights"]], rtol=0, atol=1e-7)


@pytest.mark.parametrize("accounting", ["cash", "reference"])
@pytest.mark.parametrize("warm,freq,long_short", [
    (False, 1, False), (True, 5, False), (False, 5, True)])
def test_ledger_matches_jax(accounting, warm, freq, long_short):
    """Both accountings, with and without warm-up context, the leverage
    clamp (net sum in reference mode, gross in cash mode) and the trade
    log."""
    data, prices, returns = _panel(90, seed=1)
    posterior_fn, model_fn = _closures(2, long_short)
    warmup = _panel(30, seed=3)[0] if warm else None
    kw = dict(initial_capital=5e4, tx_cost=0.002, slippage=0.001,
              max_leverage=1.0, accounting=accounting)
    got = Backtester(device="cpu", **kw).run(
        model_fn, posterior_fn, data, prices, returns, rebalance_freq=freq,
        warmup=warmup)
    want = jax_bt.Backtester(**kw).run(
        model_fn, posterior_fn, data, prices, returns, rebalance_freq=freq,
        warmup=warmup)
    _same(got, want)
    assert got.metrics["num_trades"] > 0
    first = 1 if warm and freq == 1 else freq if warm else \
        next(t for t in range(1, 90) if t % freq == 0 and t > 20)
    assert not got.positions[:first].any() and got.positions[first].any()
    if accounting == "cash":     # gross exposure capped at max_leverage
        gross = np.abs(got.positions[first] * prices[first]).sum()
        assert gross <= got.equity_curve[first - 1] * (1.0 + 1e-9)


def test_short_warmup_and_unknown_accounting_raise():
    data, prices, returns = _panel(40, seed=4)
    posterior_fn, model_fn = _closures(5)
    with pytest.raises(ValueError, match="warmup must carry"):
        Backtester(device="cpu").run(model_fn, posterior_fn, data, prices,
                                     returns, warmup=data[:, :, :5])
    with pytest.raises(ValueError, match="accounting"):
        Backtester(accounting="margin", device="cpu")
    # no step qualifies: the portfolio stays in cash
    flat = Backtester(device="cpu").run(model_fn, posterior_fn,
                                        data[:, :, :15], prices[:15],
                                        returns[:15])
    assert not flat.positions.any() and flat.metrics["num_trades"] == 0


@pytest.mark.parametrize("warm", [True, False])
def test_walk_forward_matches_jax(warm):
    """Rolling windows, the last complete window included, and a train_fn
    that swaps the closures for some windows and returns None for others."""
    data, prices, returns = _panel(200, seed=6)
    base = _closures(7)
    other = _closures(8)
    calls = []

    def train_fn(window):
        calls.append(window.shape)
        return None if len(calls) % 2 else (other[1], other[0])

    def run(cls, bt):
        calls.clear()
        wf = cls(train_window=60, test_window=35, retrain_freq=35,
                 backtester=bt, warmup=warm)
        return wf.run(base[1], base[0], train_fn, data, prices, returns)

    got = run(WalkForwardBacktest, Backtester(device="cpu"))
    n_calls = len(calls)
    want = run(jax_bt.WalkForwardBacktest, jax_bt.Backtester())
    # starts 0, 35, 70, 105: the window ending exactly at 200 is included
    assert len(got) == len(want) == n_calls == 4
    for g, w in zip(got, want):
        _same(g, w)
    assert len(got[-1].equity_curve) == 35
    assert any(r.positions.any() for r in got) or not warm


@pytest.mark.parametrize("decode", ["argmax", "viterbi"])
def test_regime_backtest_matches_jax(decode):
    data, prices, returns = _panel(150, seed=9)
    posterior_fn, model_fn = _closures(10)
    u = np.random.default_rng(11).normal(size=(1, 4, 150))
    seen = []

    def decode_fn(x, uu):
        seen.append((np.asarray(x).shape, np.asarray(uu).shape))
        return (np.asarray(uu)[:, 0] > 0.3).astype(np.int32) \
            + (np.asarray(uu)[:, 1] > 0.8)

    kw = dict(K=K, min_samples=25, decode=decode)
    if decode == "viterbi":
        kw.update(decode_fn=decode_fn, u=u)
    got = RegimeBacktest(Backtester(device="cpu")).run(
        model_fn, posterior_fn, data, prices, returns, **kw)
    want = jax_bt.RegimeBacktest(jax_bt.Backtester()).run(
        model_fn, posterior_fn, data, prices, returns, **kw)
    assert got.keys() == want.keys() and len(got) >= 1
    for k in got:
        _same(got[k], want[k])
    if decode == "viterbi":
        assert seen[0] == ((1, 5, 150), (1, 4, 150))
        with pytest.raises(ValueError, match="decode_fn"):
            RegimeBacktest(Backtester(device="cpu")).run(
                model_fn, posterior_fn, data, prices, returns, K=K,
                decode="viterbi")
    with pytest.raises(ValueError, match="unknown decode"):
        RegimeBacktest(Backtester(device="cpu")).run(
            model_fn, posterior_fn, data, prices, returns, K=K,
            decode="median")
    # precomputed regimes bypass both decodes
    fixed = RegimeBacktest(Backtester(device="cpu")).run(
        model_fn, posterior_fn, data, prices, returns, K=K,
        regimes=np.arange(150) % 2, min_samples=25)
    assert sorted(fixed) == [0, 1]


def test_closures_may_return_tensors_and_tables_render():
    data, prices, returns = _panel(60, seed=12)
    posterior_fn, model_fn = _closures(13)
    bt = Backtester(device="cpu")
    a = bt.run(model_fn, posterior_fn, data, prices, returns)
    b = bt.run(lambda q: torch.from_numpy(model_fn(q.numpy())),
               lambda x: torch.from_numpy(posterior_fn(x.numpy())),
               data, prices, returns)
    _same(b, a, atol=0)
    table = compare_strategies({"a": a, "b": b})
    assert list(table.index) == ["a", "b"] and "sharpe_ratio" in table
    assert len(a.to_dataframe()) == 60 and "sharpe_ratio" in a.summary()
    fig = plot_results(a, title="t")
    assert fig is not None and len(fig.axes) == 3


def test_cuda_backtester_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Backtester()


# ---------------------------------------------------------------------------
# End to end on the fixture panel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_stack():
    from vqvaehmm_tpu.core.config import load_config
    from vqvaehmm_tpu.models.portfolio import HeadConfig
    from vqvaehmm_tpu.models.portfolio import \
        ImprovedPortfolioOptimizer as JaxHead
    from vqvaehmm_tpu.models.vae_hmm import VAEHMM as JaxVAEHMM
    from vqvaehmm_tpu_torch import VAEHMM, ModelConfig

    cfg = load_config(os.path.join(ROOT, "artifacts", "config_quality.json"))
    tree = load_params_npz(os.path.join(
        ROOT, "artifacts", "checkpoints_quality", "vae_hmm_trained.npz"))
    head_path = os.path.join(ROOT, "artifacts", "portfolio_head.npz")
    jm = JaxVAEHMM(cfg.model)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    jhead = JaxHead(HeadConfig(K=3, n_assets=10, hidden_dim=64))
    hp = jax.tree_util.tree_map(jnp.asarray, load_params_npz(head_path))
    tm = VAEHMM(ModelConfig(**{f: getattr(cfg.model, f) for f in (
        "input_dim", "hidden_dim", "K", "hidden_dim2", "u_dim",
        "trans_hidden")}))
    tm.load_state_dict(params_from_numpy(tree))
    thead = load_improved_head(head_path, device="cpu")
    prices, regime, _ = market.load_fixture_frames(os.path.join(
        ROOT, "tests", "fixtures", "market_fixture.csv"))
    x, u, ret, aligned = market.prepare_sequences(prices, regime)
    panel = dict(data=np.transpose(x)[None], u=np.transpose(u)[None],
                 prices=aligned.values, returns=ret.values)
    jax_fns = (jax.jit(lambda q: jhead(hp, q)),
               jax.jit(lambda xx: jm.posterior(params, xx)),
               jax.jit(lambda xx, uu: jm.viterbi_decode(params, xx, uu)))

    def t_model(q):
        with torch.inference_mode():
            return thead(q)

    def t_post(xx):
        with torch.inference_mode():
            return tm.eval().posterior(xx)

    def t_decode(xx, uu):
        from vqvaehmm_tpu_torch.ops.fused_decode import fused_viterbi_states

        with torch.inference_mode():
            return fused_viterbi_states(tm, xx, uu)

    return panel, jax_fns, (t_model, t_post, t_decode)


def _metrics_close(got, want, rel=1e-4):
    for k, v in want.metrics.items():
        assert abs(got.metrics[k] - v) <= rel * max(1e-8, abs(v)), \
            (k, got.metrics[k], v)


def test_fixture_backtest_matches_jax(fixture_stack):
    panel, (j_model, j_post, _), (t_model, t_post, _) = fixture_stack
    args = (panel["data"], panel["prices"], panel["returns"])
    kw = dict(initial_capital=100000.0, tx_cost=0.001, slippage=0.0005)
    got = Backtester(device="cpu", **kw).run(t_model, t_post, *args,
                                             rebalance_freq=5)
    want = jax_bt.Backtester(**kw).run(j_model, j_post, *args,
                                       rebalance_freq=5)
    assert len(got.equity_curve) == 2327 and got.positions.any()
    _metrics_close(got, want)
    np.testing.assert_allclose(got.equity_curve, want.equity_curve,
                               rtol=1e-4)


@pytest.mark.parametrize("decode", ["argmax", "viterbi"])
def test_fixture_regime_backtest_matches_jax(fixture_stack, decode):
    panel, (j_model, j_post, j_dec), (t_model, t_post, t_dec) = fixture_stack
    args = (panel["data"], panel["prices"], panel["returns"])
    kw = dict(K=3, decode=decode)
    got = RegimeBacktest(Backtester(device="cpu")).run(
        t_model, t_post, *args, **kw,
        **(dict(decode_fn=t_dec, u=panel["u"]) if decode == "viterbi"
           else {}))
    want = jax_bt.RegimeBacktest(jax_bt.Backtester()).run(
        j_model, j_post, *args, **kw,
        **(dict(decode_fn=j_dec, u=panel["u"]) if decode == "viterbi"
           else {}))
    assert got.keys() == want.keys() and len(got) >= 2
    for k in got:
        # equal regime counts: the decoded panels agree step for step
        assert len(got[k].returns) == len(want[k].returns), k
        _metrics_close(got[k], want[k])
