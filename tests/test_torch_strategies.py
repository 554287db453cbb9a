"""The port's training strategies (vqvaehmm_tpu_torch/train/strategies.py)
on the CPU against vqvaehmm_tpu/train/strategies.py, from the same heads
(JAX's parameters carried across by zoo_params_from_numpy) and the same
numpy tasks: MAML's adapted parameters and second-order meta steps (an
MLP head and the LSTM head), the online optimizer's clipped Adam and EMA
shadow, and the walk-forward trainer's windows, guards and changes of lr
and loss between windows.  Values within 1e-4 (relative for losses and
Sharpe ratios, absolute for parameters)."""

import jax
import numpy as np
import pytest
import torch

import vqvaehmm_tpu.losses as jl
import vqvaehmm_tpu.models.portfolio as jp
import vqvaehmm_tpu.train.strategies as js
import vqvaehmm_tpu_torch.losses.portfolio as tl
import vqvaehmm_tpu_torch.models.portfolio as tp
import vqvaehmm_tpu_torch.train.strategies as ts
from tests.torch_port import close
from vqvaehmm_tpu_torch.data.checkpoint import zoo_params_from_numpy

CFG = (3, 4, 8)


def _pair(name="HierarchicalPortfolioOptimizer", seed=0):
    jm = getattr(jp, name)(jp.HeadConfig(*CFG))
    params = jm.init(jax.random.PRNGKey(seed))
    tm = getattr(tp, name)(tp.HeadConfig(*CFG))
    tm.load_state_dict(zoo_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tm))
    return jm, params, tm


def _task(rng, B=8, T=10, seq=False):
    q = rng.dirichlet(np.ones(3), size=(B, 6) if seq else B) \
        .astype(np.float32)
    if seq:
        q = q.transpose(0, 2, 1).copy()               # (B, K, T)
    r = rng.normal(1e-3, 0.01, size=(B, T, 4)).astype(np.float32)
    return q, r


def _same_params(module, tree, atol, what=""):
    want = zoo_params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))
    got = dict(module.named_parameters()) if isinstance(
        module, torch.nn.Module) else module
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        close(v.detach(), want[k], atol, f"{what} {k}")


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("name", ["HierarchicalPortfolioOptimizer",
                                  "RegimeLSTMOptimizer"])
def test_maml_matches_jax(name):
    """adapt: n_inner SGD steps; meta_update: the summed query loss and
    the Adam step on its second-order gradient, three times."""
    rng = np.random.default_rng(0)
    seq = name == "RegimeLSTMOptimizer"
    jm, params, tm = _pair(name)
    jmeta = js.MetaPortfolioOptimizer(jm, params, inner_lr=0.05,
                                      outer_lr=0.01, n_inner=3)
    tmeta = ts.MetaPortfolioOptimizer(tm, inner_lr=0.05, outer_lr=0.01,
                                      n_inner=3)
    support = _task(rng, seq=seq)
    _same_params(tmeta.adapt(support, tl.sharpe_loss),
                 jmeta.adapt(support, jl.sharpe_loss), 1e-5, "adapted")
    # the meta step moved no parameter
    _same_params(tm, params, 0.0, "after adapt")
    tasks = [(_task(rng, seq=seq), _task(rng, seq=seq)) for _ in range(2)]
    for i in range(3):
        want = jmeta.meta_update(tasks, jl.sharpe_loss)
        got = tmeta.meta_update(tasks, tl.sharpe_loss)
        assert _rel(got, want) <= 1e-4, (i, got, want)
        _same_params(tm, jmeta.params, 1e-4, f"meta step {i}")


def test_online_optimizer_matches_jax():
    """Ten clipped Adam updates (a large return scale so that the clip
    acts), the EMA shadow after each, a custom loss with a step cached
    for it, and use_ema."""
    rng = np.random.default_rng(1)
    jm, params, tm = _pair()
    jopt = js.OnlinePortfolioOptimizer(jm, params, lr=0.01, ema_decay=0.5,
                                       gradient_clip=0.5)
    topt = ts.OnlinePortfolioOptimizer(tm, lr=0.01, ema_decay=0.5,
                                       gradient_clip=0.5)
    for i in range(10):
        q, r = _task(rng)
        r = r * (30.0 if i % 2 else 1.0)
        assert _rel(topt.update(q, r), jopt.update(q, r)) <= 1e-4
        _same_params(tm, jopt.params, 1e-5, f"update {i}")
        _same_params(topt.ema_params, jopt.ema_params, 1e-5, f"ema {i}")
    for _ in range(2):
        q, r = _task(rng)
        assert _rel(topt.update(q, r, loss_fn=tl.sortino_loss),
                    jopt.update(q, r, loss_fn=jl.sortino_loss)) <= 1e-4
    assert list(topt._custom_steps) == [tl.sortino_loss]
    _same_params(tm, jopt.params, 1e-5, "custom")
    topt.use_ema()
    jopt.use_ema()
    _same_params(tm, jopt.ema_params, 1e-5, "use_ema")
    for k, p in tm.named_parameters():
        assert torch.equal(p.detach(), topt.ema_params[k])


def _wf_pair(rng, n=100):
    jm, params, tm = _pair(seed=2)
    q = rng.dirichlet(np.ones(3), size=n).astype(np.float32)
    rets = rng.normal(1e-3, 0.01, size=(n, 5, 4)).astype(np.float32)
    jwf = js.WalkForwardTrainer(jm, params, jl.sharpe_loss,
                                train_window=40, test_window=10,
                                retrain_freq=10, lr=0.01)
    twf = ts.WalkForwardTrainer(tm, tl.sharpe_loss, train_window=40,
                                test_window=10, retrain_freq=10, lr=0.01)
    return jwf, twf, tm, (q, rets)


def test_walk_forward_trainer_matches_jax():
    """Three windows: the train loss before each window's last step and
    the test Sharpe ratio, then the parameters."""
    jwf, twf, tm, data = _wf_pair(np.random.default_rng(3))
    want = jwf.run(data, n_periods=3)
    got = twf.run(data, n_periods=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["test_sharpe", "train_loss"]
        for k in g:
            assert _rel(g[k], w[k]) <= 1e-4, (k, g[k], w[k])
    _same_params(tm, jwf.params, 1e-4, "walk-forward")


def test_walk_forward_guards_and_changes_between_windows():
    """n_epochs <= 0 is a no-op returning 0.0, too few rows raise JAX's
    ValueError, and lr and loss_fn changed between windows take effect,
    as in JAX."""
    jwf, twf, tm, (q, rets) = _wf_pair(np.random.default_rng(4))
    before = {k: v.detach().clone() for k, v in tm.named_parameters()}
    assert twf.train_epoch((q[:40], rets[:40]), n_epochs=0) == 0.0
    assert twf.train_epoch((q[:40], rets[:40]), n_epochs=-1) == 0.0
    for k, v in tm.named_parameters():
        assert torch.equal(v.detach(), before[k])
    with pytest.raises(ValueError, match="need"):
        twf.run((q, rets), n_periods=20)
    for lr, loss in ((1e-2, "sharpe_loss"), (1e-4, "sharpe_loss"),
                     (1e-3, "risk_parity_loss")):
        jwf.lr = twf.lr = lr
        jwf.loss_fn, twf.loss_fn = getattr(jl, loss), getattr(tl, loss)
        want = jwf.train_epoch((q[:40], rets[:40]), n_epochs=3)
        got = twf.train_epoch((q[:40], rets[:40]), n_epochs=3)
        assert _rel(got, want) <= 1e-4, (lr, loss)
        assert _rel(twf.evaluate((q[40:50], rets[40:50])),
                    jwf.evaluate((q[40:50], rets[40:50]))) <= 1e-4
    _same_params(tm, jwf.params, 1e-4, "after the changes")
