"""The port's GMM stack (vqvaehmm_tpu_torch/train/gmm_pipeline.py and the
CLI's --stack gmm) against the JAX package's on the CPU: the head stage
from JAX's fitted GMM and initial head, the temporal chain, the `.npz`
archive both ways, the equal-weight benchmark and the report."""

import jax
import numpy as np
import pytest
import torch

import tests.torch_port  # noqa: F401  (one torch thread per worker)
from tests.test_torch_gmm import fixture_returns
from vqvaehmm_tpu.models.portfolio import HeadConfig as JaxHeadConfig
from vqvaehmm_tpu.models.portfolio import \
    ImprovedPortfolioOptimizer as JaxHead
from vqvaehmm_tpu.train import gmm_pipeline as jpipe
from vqvaehmm_tpu_torch.data.checkpoint import \
    improved_head_params_from_numpy
from vqvaehmm_tpu_torch.models.gmm import (SimpleRegimeDetector, _as_params,
                                           prepare_regime_features)
from vqvaehmm_tpu_torch.train import gmm_pipeline as pipe

HIDDEN = 16


def _head_state(params):
    return improved_head_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params))


def port_detector(jax_detector) -> SimpleRegimeDetector:
    """The JAX detector's fitted GMM and statistics in the port's."""
    det = SimpleRegimeDetector(jax_detector.n_regimes, device="cpu")
    det.gmm.params = _as_params([np.asarray(a) for a in
                                 jax_detector.gmm.params], "cpu")
    det.feature_mu = jax_detector.feature_mu
    det.feature_sd = jax_detector.feature_sd
    det.fitted = True
    return det


def _pair(returns, **kw):
    """(JAX system, port system) trained from JAX's detector and JAX's
    initial head (PRNGKey(0), as train_improved_system draws it)."""
    js = jpipe.train_improved_system(returns, hidden_dim=HIDDEN,
                                     log_fn=None, **kw)
    init = JaxHead(JaxHeadConfig(K=3, n_assets=returns.shape[1],
                                 hidden_dim=HIDDEN)).init(
        jax.random.PRNGKey(0))
    ps = pipe.train_improved_system(returns, hidden_dim=HIDDEN, log_fn=None,
                                    device="cpu",
                                    detector=port_detector(js.detector),
                                    head_init=_head_state(init), **kw)
    return js, ps


@pytest.fixture(scope="module")
def temporal_pair():
    return _pair(fixture_returns(400), num_epochs=40, temporal=True)


def _check_head_stage(js, ps):
    assert len(ps.history) == len(js.history)        # the same stop
    np.testing.assert_allclose(ps.history, js.history, rtol=1e-5)
    want = _head_state(js.params)
    for name, p in ps.optimizer.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_head_stage_and_chain_match_jax(temporal_pair):
    js, ps = temporal_pair
    _check_head_stage(js, ps)
    # the chain is fitted over the detector's densities, which the two
    # packages round differently (float32 Mahalanobis distances of
    # correlated features); its transition probabilities agree within 1e-4
    for got, want in zip(ps.chain, js.chain):
        np.testing.assert_allclose(got.exp().numpy(), np.exp(want), rtol=0,
                                   atol=1e-4)


def test_early_stop_matches_jax():
    """A run that stops early: the same stopping epoch and history, and
    the best epoch's parameters (a copy, not the last ones)."""
    js, ps = _pair(fixture_returns(400), num_epochs=60, patience=2,
                   lr=1e-5)
    assert len(ps.history) < 60
    _check_head_stage(js, ps)


def test_dropout_training_mode():
    """dropout=True: another trajectory than the default, the same one
    twice from one seed."""
    r = fixture_returns(300)
    kw = dict(hidden_dim=8, num_epochs=6, patience=6, log_fn=None,
              device="cpu")
    det = pipe.train_improved_system(r, **kw)
    d1 = pipe.train_improved_system(r, dropout=True, detector=det.detector,
                                    **kw)
    d2 = pipe.train_improved_system(r, dropout=True, detector=det.detector,
                                    **kw)
    assert d1.history != det.history and d1.history == d2.history
    assert not d1.optimizer.training


def test_head_leaf_order_is_jax_flatten_order():
    params = JaxHead(JaxHeadConfig(K=3, n_assets=4, hidden_dim=5)).init(
        jax.random.PRNGKey(1))
    paths = [".".join(k.key for k in path) for path, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    assert tuple(paths) == pipe.HEAD_LEAF_ORDER


def _check_archive(got, want, feats):
    """Two systems loaded from one archive, one in each package: the same
    labels, probabilities within 1e-4 (JAX's float32 densities of the
    correlated features part from the port's float64 ones by some 7e-6
    here), the head's weights on the same probabilities within 1e-6 and
    both marginal modes of the chain within 1e-4.  (port, JAX) order."""
    np.testing.assert_array_equal(got.detector.predict_regime(feats),
                                  want.detector.predict_regime(feats))
    np.testing.assert_allclose(got.detector.predict_proba(feats),
                               want.detector.predict_proba(feats), rtol=0,
                               atol=1e-4)
    probs = np.array(want.detector.predict_proba(feats[:8]))
    with torch.no_grad():
        w = got.optimizer(torch.from_numpy(probs)).numpy()
    np.testing.assert_allclose(w, np.asarray(want.optimizer(want.params,
                                                            probs)),
                               rtol=0, atol=1e-6)
    assert got.history == [float(h) for h in want.history]
    for mode in ("smoothed", "filtered"):
        np.testing.assert_allclose(got.regime_marginals(feats, mode),
                                   want.regime_marginals(feats, mode),
                                   rtol=0, atol=1e-4, err_msg=mode)


def test_archive_both_ways(temporal_pair, tmp_path):
    js, ps = temporal_pair
    feats = prepare_regime_features(fixture_returns(400))
    js.save(str(tmp_path / "jax.npz"))           # JAX writes, the port reads
    _check_archive(pipe.load_improved_system(str(tmp_path / "jax.npz"),
                                             device="cpu"), js, feats)
    ps.save(str(tmp_path / "port.npz"))          # the port writes, JAX reads
    _check_archive(ps, jpipe.load_improved_system(str(tmp_path / "port.npz")),
                   feats)
    # and the port reads its own archive back bit for bit
    again = pipe.ImprovedSystem.load(str(tmp_path / "port.npz"),
                                     device="cpu")
    for mode in ("smoothed", "filtered"):
        np.testing.assert_array_equal(again.regime_marginals(feats, mode),
                                      ps.regime_marginals(feats, mode))
    with pytest.raises(ValueError, match="unfitted"):
        pipe.ImprovedSystem(SimpleRegimeDetector(device="cpu"),
                            ps.optimizer, []).save(str(tmp_path / "x.npz"))


def test_benchmark_equal_weight_matches_jax():
    r = fixture_returns(300)
    assert pipe.benchmark_equal_weight(r, rebalance_freq=10) == \
        jpipe.benchmark_equal_weight(r, rebalance_freq=10)


@pytest.mark.parametrize("data", [True, False])
def test_report_gmm_and_cli_match_jax(temporal_pair, tmp_path, data):
    """--stack gmm through the port's CLI on a JAX-written archive, with a
    returns panel and with the synthetic one: within 1e-5 of JAX's
    report_gmm, the current regime equal."""
    from vqvaehmm_tpu.serve.cli import report_gmm as jax_report
    from vqvaehmm_tpu_torch.serve.cli import main

    js, _ = temporal_pair
    path = str(tmp_path / "sys.npz")
    js.save(path)
    argv = ["--stack", "gmm", "--checkpoint", path, "--device", "cpu"]
    if data:
        returns = fixture_returns(300)
        np.save(tmp_path / "r.npy", returns)
        argv += ["--data", str(tmp_path / "r.npy")]
    else:
        returns = np.random.default_rng(0).normal(
            5e-4, 0.01, size=(252, js.optimizer.cfg.n_assets))
    got = main(argv)
    want = jax_report(jpipe.load_improved_system(path), returns, log_fn=None)
    assert got["current_regime"] == want["current_regime"]
    for key in ("regime_probs", "regime_distribution", "last_allocations"):
        np.testing.assert_allclose(np.array(got[key]), np.array(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(list(got["allocation"].values()),
                               list(want["allocation"].values()), rtol=0,
                               atol=1e-5)
