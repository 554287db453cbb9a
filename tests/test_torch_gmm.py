"""The port's GMM regime detector (vqvaehmm_tpu_torch/models/gmm.py)
against the JAX package's on the CPU: the numpy feature recipe against
JAX's pandas recipe, the component log-densities, one EM step and a full
fit from JAX's restarts, a diverged restart, and sklearn migration."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port  # noqa: F401  (one torch thread per worker)
from vqvaehmm_tpu.models import gmm as jgmm
from vqvaehmm_tpu_torch.data import market
from vqvaehmm_tpu_torch.models import gmm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "market_fixture.csv")


def fixture_returns(T: int) -> np.ndarray:
    """The first T days of the fixture panel's (T, 10) asset returns."""
    prices, regime, _ = market.load_fixture_frames(FIXTURE)
    ret = market.prepare_sequences(prices, regime)[2]
    return np.asarray(ret.values, np.float32)[:T]


def normalised_features(T: int) -> np.ndarray:
    f = gmm.prepare_regime_features(fixture_returns(T))
    return (f - f.mean(0)) / (f.std(0) + 1e-8)


def _panel(A: int, case: str) -> np.ndarray:
    rng = np.random.default_rng(A)
    r = rng.normal(5e-4, 0.01, size=(160, A)).astype(np.float32)
    if case == "flat_stretch":
        r[40:75] = 0.0                # every window inside is constant
        r[90:93] = 0.002
    elif case == "flat_column":
        r[:70, A - 1] = 0.0           # one asset constant over windows
    elif case == "short":
        r = r[:12]                    # every row a warm-up row
    return r


@pytest.mark.parametrize("A", [1, 4])
@pytest.mark.parametrize("case", ["random", "flat_stretch", "flat_column",
                                  "short"])
def test_features_match_pandas(A, case):
    """prepare_regime_features in numpy against the JAX package's pandas
    recipe: one row a day, finite, within 1e-5 x max(1, |ref|)."""
    r = _panel(A, case)
    got = gmm.prepare_regime_features(r)
    want = jgmm.prepare_regime_features(r)
    assert got.shape == (len(r), 13) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_array_less(np.abs(got - want),
                                 1e-5 * np.maximum(1.0, np.abs(want)) + 1e-30)


def _random_params(rng, R, K, D):
    a = rng.normal(size=(R, K, D, D))
    covs = a @ np.swapaxes(a, -1, -2) / D + 0.5 * np.eye(D)
    w = rng.dirichlet(np.ones(K), size=R)
    return gmm.GMMParams(w.astype(np.float32),
                         rng.normal(size=(R, K, D)).astype(np.float32),
                         covs.astype(np.float32))


def test_log_prob_and_one_em_step_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 5)).astype(np.float32)
    p = _random_params(rng, 2, 3, 5)
    got = gmm._log_prob_components(gmm._as_params(p, "cpu"),
                                   torch.from_numpy(x)).numpy()
    for r in range(2):
        want = jgmm._log_prob_components(
            jgmm.GMMParams(*(jnp.asarray(a[r]) for a in p)), jnp.asarray(x))
        np.testing.assert_allclose(got[r], np.asarray(want), rtol=0,
                                   atol=1e-4)
    jg = jgmm.GaussianMixture(3, n_iter=1)
    want, want_ll = jax.vmap(jg._em, in_axes=(0, None))(
        jgmm.GMMParams(*(jnp.asarray(a) for a in p)), jnp.asarray(x))
    got, got_ll = gmm.GaussianMixture(3, n_iter=1, device="cpu")._em(
        gmm._as_params(p, "cpu"), torch.from_numpy(x))
    for g, w in zip((*got, got_ll), (*want, want_ll)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


@pytest.fixture(scope="module")
def jax_fit():
    """JAX's fit of n_init=4 on 400 days of fixture features, its
    restarts' inits and every restart's final log-likelihood."""
    x = normalised_features(400)
    jg = jgmm.GaussianMixture(3, n_init=4, seed=0).fit(x)
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    inits = jax.vmap(lambda k: jg._init_params(k, jnp.asarray(x)))(keys)
    _, lls = jax.jit(jax.vmap(jg._em, in_axes=(0, None)))(inits,
                                                          jnp.asarray(x))
    return x, jg, [np.asarray(a) for a in inits], np.asarray(lls)


def test_fit_matches_jax_from_its_restarts(jax_fit):
    x, jg, inits, lls = jax_fit
    pg = gmm.GaussianMixture(3, n_init=4, seed=0, device="cpu").fit(
        x, init=inits)
    np.testing.assert_allclose(pg.lls_, lls, rtol=1e-5)
    np.testing.assert_allclose(pg.log_likelihood_, jg.log_likelihood_,
                               rtol=1e-5)
    np.testing.assert_allclose(pg.predict_proba(x), jg.predict_proba(x),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(pg.predict(x), jg.predict(x))
    # the EM has not converged after 100 steps: the two packages'
    # parameters drift apart along the likelihood's flat directions, so
    # per-sample densities differ by up to some 0.03 while their sum, the
    # likelihood, agrees
    assert pg.score_samples(x).shape == (len(x),)
    assert pg.score(x) == pytest.approx(jg.score(x), rel=1e-5)
    # without inits: the port's own seeded draws, distinct data points
    own = gmm.GaussianMixture(3, n_init=4, seed=0, device="cpu")
    first = own._init_params(torch.from_numpy(x))
    assert first.means.shape == (4, 3, x.shape[1])
    assert all(len({tuple(m) for m in r.tolist()}) == 3
               for r in first.means)
    own.fit(x)
    assert np.isfinite(own.log_likelihood_)


def test_non_positive_definite_restart_never_wins(jax_fit):
    """A restart whose covariance is not positive definite gets -inf (the
    port's cholesky_ex carries NaN where JAX's cholesky returns it) and
    cannot win, in both packages."""
    x, _, inits, _ = jax_fit
    bad = [a.copy() for a in inits]
    bad[2][0] = -np.eye(x.shape[1], dtype=np.float32)
    pg = gmm.GaussianMixture(3, n_init=4, device="cpu").fit(x, init=bad)
    jg = jgmm.GaussianMixture(3, n_init=4)
    finals, jll = jax.vmap(jg._em, in_axes=(0, None))(
        jgmm.GMMParams(*(jnp.asarray(a) for a in bad)), jnp.asarray(x))
    assert np.isnan(np.asarray(jll)[0]) and pg.lls_[0] == -np.inf
    jll = np.where(np.isnan(np.asarray(jll)), -np.inf, np.asarray(jll))
    assert int(np.argmax(pg.lls_)) == int(np.argmax(jll)) != 0
    assert np.isfinite(pg.log_likelihood_)
    assert np.isfinite(pg.predict_proba(x)).all()


class _RefDetector:
    """The reference's pickled detector: a wrapper exposing .gmm."""

    def __init__(self, sk):
        self.n_regimes = sk.n_components
        self.gmm = sk


def test_from_sklearn_matches_sklearn_and_jax():
    sklearn_mix = pytest.importorskip("sklearn.mixture")
    rng = np.random.default_rng(1)
    f = np.concatenate([rng.normal(-2, 0.5, size=(120, 4)),
                        rng.normal(2, 0.5, size=(120, 4))]).astype(np.float32)
    sk = sklearn_mix.GaussianMixture(n_components=2, covariance_type="full",
                                     random_state=42, n_init=3).fit(f)
    test_f = rng.normal(0, 2.5, size=(40, 4)).astype(np.float32)
    for src in (sk, _RefDetector(sk)):
        det = gmm.SimpleRegimeDetector.from_sklearn(src, device="cpu")
        np.testing.assert_allclose(det.predict_proba(test_f),
                                   sk.predict_proba(test_f), atol=1e-4)
        np.testing.assert_array_equal(det.predict_regime(test_f),
                                      sk.predict(test_f))
    jdet = jgmm.SimpleRegimeDetector.from_sklearn(sk, f.mean(0), f.std(0))
    det = gmm.SimpleRegimeDetector.from_sklearn(sk, f.mean(0), f.std(0),
                                                device="cpu")
    # the port's densities are float64, JAX's float32
    np.testing.assert_allclose(det.predict_proba(test_f),
                               jdet.predict_proba(test_f), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="FITTED"):
        gmm.SimpleRegimeDetector.from_sklearn(
            sklearn_mix.GaussianMixture(n_components=2), device="cpu")
    diag = sklearn_mix.GaussianMixture(n_components=2,
                                       covariance_type="diag",
                                       random_state=0).fit(f)
    with pytest.raises(ValueError, match="full"):
        gmm.SimpleRegimeDetector.from_sklearn(diag, device="cpu")
    with pytest.raises(ValueError, match="feature_sd"):
        gmm.SimpleRegimeDetector.from_sklearn(sk, f.mean(0), device="cpu")


def test_unfitted_and_device():
    f = np.zeros((5, 13), np.float32)
    with pytest.raises(ValueError, match="not fitted"):
        gmm.SimpleRegimeDetector(device="cpu").predict_proba(f)
    with pytest.raises(ValueError, match="not fitted"):
        gmm.GaussianMixture(device="cpu").predict(f)
    if not torch.cuda.is_available():
        # the card is the default, and nothing moves to the CPU unasked
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gmm.SimpleRegimeDetector()
