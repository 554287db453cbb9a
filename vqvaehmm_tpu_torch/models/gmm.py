"""Gaussian-mixture regime detection (counterpart of
vqvaehmm_tpu/models/gmm.py): the reference's alternative stack, a
full-covariance GaussianMixture fitted with n_init restarts over
engineered features.

All n_init restarts run as one batch: every tensor of the EM carries a
leading restart axis (the JAX package vmaps `_em` over its restarts), and
the EM loop is a Python loop of n_iter steps over those tensors; the best
final log-likelihood wins.  Cholesky factors, triangular solves and
log-sum-exp are library calls, as in the JAX package, which runs them
outside any Pallas kernel.  `torch.linalg.cholesky_ex` does not raise on
a matrix that is not positive definite: such a factor is set to NaN, as
`jnp.linalg.cholesky` returns it, so a diverged restart's likelihood is
NaN and it cannot win.

The EM and every density run in float64 on the device; the fitted
parameters are kept in float32, as the JAX package keeps them and its
archive stores them.  The engineered features are strongly correlated
(covariance eigenvalues down to some 1e-4 after normalisation), so in
float32 the Mahalanobis distances of outlying days carry relative errors
of some 1e-3: in float32 an H100 and the CPU gave responsibilities
1.4e-4 apart on the fixture panel.  In float64 the two devices agree,
and the port stays as close to the JAX package's float32 fit as a
float32 port was.

The restarts' initial means are drawn from a `torch.Generator` seeded
with `seed` (the JAX package draws with `jax.random.choice`, another
stream); `fit(x, init=...)` takes explicit initial parameters instead.
`prepare_regime_features` is the JAX package's pandas recipe in numpy,
float64 throughout and cast to float32 at the end.
"""

from __future__ import annotations

import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device


class GMMParams(NamedTuple):
    weights: torch.Tensor  # (..., K)
    means: torch.Tensor    # (..., K, D)
    covs: torch.Tensor     # (..., K, D, D)


def _as_params(params, device) -> GMMParams:
    """GMMParams of float32 tensors on `device` from tensors or numpy
    arrays."""
    return GMMParams(*(
        (a if isinstance(a, torch.Tensor)
         else torch.from_numpy(np.array(a, np.float32)))
        .to(device=device, dtype=torch.float32) for a in params))


def _log_gaussian(x: torch.Tensor, mean: torch.Tensor,
                  cov: torch.Tensor) -> torch.Tensor:
    """x (N, D); mean (..., D); cov (..., D, D) -> (..., N) log N(x | mean,
    cov).  A covariance that is not positive definite gives NaN."""
    D = x.shape[-1]
    chol, info = torch.linalg.cholesky_ex(cov)
    chol = torch.where((info != 0)[..., None, None],
                       torch.full_like(chol, math.nan), chol)
    diff = x - mean[..., None, :]                               # (..., N, D)
    sol = torch.linalg.solve_triangular(chol, diff.transpose(-1, -2),
                                        upper=False)            # (..., D, N)
    maha = (sol ** 2).sum(-2)
    logdet = 2.0 * torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return -0.5 * (D * math.log(2 * math.pi) + logdet[..., None] + maha)


def _log_prob_components(params: GMMParams, x: torch.Tensor) -> torch.Tensor:
    """(..., N, K) log w_k + log N(x | mu_k, Sigma_k); a leading restart
    axis on the parameters carries through."""
    lps = _log_gaussian(x, params.means, params.covs)           # (..., K, N)
    return lps.transpose(-1, -2) + torch.log(params.weights)[..., None, :]


class GaussianMixture:
    """sklearn-like API: fit / predict / predict_proba / score /
    score_samples, on `device`.  log_likelihood_ is the TOTAL training
    log-likelihood of the fitted parameters (sklearn's lower_bound_ is
    the per-sample mean: score() gives that); lls_ holds every restart's,
    NaN already replaced by -inf."""

    def __init__(self, n_components: int = 3, n_init: int = 10,
                 n_iter: int = 100, reg_covar: float = 1e-6,
                 seed: int = 0, device="cuda"):
        self.K = n_components
        self.n_init = n_init
        self.n_iter = n_iter
        self.reg_covar = reg_covar
        self.seed = seed
        self.device = resolve_device(device)
        self.params: Optional[GMMParams] = None
        self.log_likelihood_: float = -np.inf
        self.lls_: Optional[np.ndarray] = None

    # -- EM ------------------------------------------------------------

    def _init_params(self, x: torch.Tensor) -> GMMParams:
        """n_init restarts: K distinct data points as the means (drawn on
        the host from a Generator seeded with `seed`), the data's
        covariance (ddof=1) plus reg_covar for every component, equal
        weights."""
        N, D = x.shape
        g = torch.Generator().manual_seed(self.seed)
        idx = torch.stack([torch.randperm(N, generator=g)[:self.K]
                           for _ in range(self.n_init)]).to(x.device)
        cov0 = torch.cov(x.T) + self.reg_covar * torch.eye(
            D, dtype=x.dtype, device=x.device)
        return GMMParams(
            torch.full((self.n_init, self.K), 1.0 / self.K, dtype=x.dtype,
                       device=x.device),
            x[idx], cov0.expand(self.n_init, self.K, D, D).clone())

    def _em(self, params: GMMParams, x: torch.Tensor):
        """n_iter EM steps of every restart at once (a leading restart
        axis on params) -> (params, final log-likelihoods (R,)), the
        likelihoods of the final parameters."""
        eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
        for _ in range(self.n_iter):
            resp = torch.softmax(_log_prob_components(params, x), dim=-1)
            nk = resp.sum(-2) + 1e-10                           # (R, K)
            weights = nk / nk.sum(-1, keepdim=True)
            means = (resp.transpose(-1, -2) @ x) / nk[..., None]
            diff = x[:, None, :] - means[..., None, :, :]       # (R, N, K, D)
            covs = torch.einsum("rnk,rnkd,rnke->rkde", resp, diff, diff) \
                / nk[..., None, None] + self.reg_covar * eye
            params = GMMParams(weights, means, covs)
        final_ll = torch.logsumexp(_log_prob_components(params, x),
                                   dim=-1).sum(-1)
        return params, final_ll

    def _data(self, x) -> torch.Tensor:
        """x as float32 (the JAX package's input), then float64 on the
        device."""
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            device=self.device, dtype=torch.float64)

    def fit(self, x, init=None) -> "GaussianMixture":
        """Fit every restart, keep the best.  init: optional GMMParams
        (weights (R, K), means (R, K, D), covs (R, K, D, D)), tensors or
        numpy arrays, the restarts' starting points in place of the
        seeded draws."""
        x = self._data(x)
        inits = (self._init_params(x) if init is None
                 else GMMParams(*(a.double() for a in
                                  _as_params(init, self.device))))
        finals, lls = self._em(inits, x)
        # a diverged restart's NaN likelihood must not win the argmax
        # (torch.argmax, like numpy's, returns a NaN's index)
        lls = torch.where(torch.isnan(lls), -math.inf, lls)
        best = int(torch.argmax(lls))
        self.params = GMMParams(*(a[best].float() for a in finals))
        self.lls_ = lls.cpu().numpy()
        self.log_likelihood_ = float(self.lls_[best])
        return self

    def _require_fitted(self):
        if self.params is None:
            raise ValueError(
                "GaussianMixture is not fitted; call fit(X) first")

    # -- inference -----------------------------------------------------

    def log_prob_components(self, x) -> torch.Tensor:
        """(N, K) log w_k + log N(x | mu_k, Sigma_k) of the fitted
        parameters on the device, float64."""
        self._require_fitted()
        return _log_prob_components(
            GMMParams(*(a.double() for a in self.params)), self._data(x))

    def predict_proba(self, x) -> np.ndarray:
        return torch.softmax(self.log_prob_components(x), dim=-1).float() \
            .cpu().numpy()

    def predict(self, x) -> np.ndarray:
        return self.predict_proba(x).argmax(-1)

    def score_samples(self, x) -> np.ndarray:
        return torch.logsumexp(self.log_prob_components(x), dim=-1).float() \
            .cpu().numpy()

    def score(self, x) -> float:
        """Mean per-sample log-likelihood (sklearn semantics)."""
        return float(self.score_samples(x).mean())


class SimpleRegimeDetector:
    """GMM regime detector over engineered features (reference:
    train_simple.py:10-28).  The detector owns feature normalisation:
    fit() learns mu/sd from its training features and every predict
    applies the same statistics (save_improved_system persists them)."""

    def __init__(self, n_regimes: int = 3, n_init: int = 10, seed: int = 0,
                 device="cuda"):
        self.n_regimes = n_regimes
        self.gmm = GaussianMixture(n_components=n_regimes, n_init=n_init,
                                   seed=seed, device=device)
        self.fitted = False
        self.feature_mu: Optional[np.ndarray] = None
        self.feature_sd: Optional[np.ndarray] = None

    def _norm(self, features) -> np.ndarray:
        f = np.asarray(features, np.float32)
        if self.feature_mu is None:
            return f
        return (f - self.feature_mu) / self.feature_sd

    def fit(self, features) -> "SimpleRegimeDetector":
        f = np.asarray(features, np.float32)
        self.feature_mu = f.mean(0)
        self.feature_sd = f.std(0) + 1e-8
        self.gmm.fit(self._norm(f))
        self.fitted = True
        return self

    @classmethod
    def from_sklearn(cls, sk_gmm, feature_mu=None, feature_sd=None,
                     device="cuda") -> "SimpleRegimeDetector":
        """A fitted detector from a fitted sklearn GaussianMixture (the
        estimator inside the reference's `regime_detector.pkl`), or any
        wrapper exposing it as `.gmm`, duck-typed: sklearn is never
        imported here.  Only covariance_type='full' maps onto GMMParams.
        feature_mu/feature_sd: the z-scoring statistics the features were
        normalised with, if any."""
        sk = getattr(sk_gmm, "gmm", sk_gmm)
        for attr in ("weights_", "means_", "covariances_"):
            if not hasattr(sk, attr):
                raise ValueError(
                    f"{type(sk).__name__} has no {attr}; expected a "
                    "FITTED sklearn GaussianMixture (or a wrapper with "
                    "a .gmm attribute holding one)")
        covs = np.asarray(sk.covariances_, np.float32)
        means = np.asarray(sk.means_, np.float32)
        K = means.shape[0]
        if covs.shape != (K, means.shape[1], means.shape[1]):
            raise ValueError(
                f"covariances_ shape {covs.shape} is not full-covariance "
                f"(K, D, D); only covariance_type='full' (the reference's, "
                "train_simple.py:14) is supported")
        det = cls(n_regimes=K, device=device)
        det.gmm.params = _as_params(
            (np.asarray(sk.weights_, np.float32), means, covs),
            det.gmm.device)
        det.gmm.log_likelihood_ = float(getattr(sk, "lower_bound_", np.nan))
        if feature_mu is not None:
            if feature_sd is None:
                raise ValueError("feature_mu given without feature_sd")
            det.feature_mu = np.asarray(feature_mu, np.float32)
            det.feature_sd = np.asarray(feature_sd, np.float32)
        det.fitted = True
        return det

    def predict_regime(self, features) -> np.ndarray:
        self._require_fitted()
        return self.gmm.predict(self._norm(features))

    def predict_proba(self, features) -> np.ndarray:
        self._require_fitted()
        return self.gmm.predict_proba(self._norm(features))

    def _require_fitted(self):
        if not self.fitted:
            raise ValueError(
                "SimpleRegimeDetector is not fitted; call fit() first")


def _windows(a: np.ndarray, n: int) -> np.ndarray:
    """(T, ...) -> (T - n + 1, n, ...): the trailing windows of n rows
    ending at rows n-1 .. T-1."""
    return np.moveaxis(np.lib.stride_tricks.sliding_window_view(a, n, 0),
                       -1, 1)


def _rolling(a: np.ndarray, n: int, fn) -> np.ndarray:
    """pandas' Series.rolling(n).<fn>(): fn over each trailing window of a
    (T,) series, NaN over the first n-1 rows."""
    out = np.full(a.shape[0], np.nan)
    if a.shape[0] >= n:
        out[n - 1:] = fn(_windows(a, n))
    return out


def _moments(w: np.ndarray):
    """Window statistics (n, mean-centred second, third and fourth
    moments, and whether the window is constant) of (W, n) windows."""
    n = w.shape[1]
    d = w - w.mean(1, keepdims=True)
    return (n, (d ** 2).mean(1), (d ** 3).mean(1), (d ** 4).mean(1),
            w.max(1) == w.min(1))


def _std(w: np.ndarray) -> np.ndarray:
    n, B, _, _, flat = _moments(w)
    return np.where(flat, 0.0, np.sqrt(B * n / (n - 1)))


def _skew(w: np.ndarray) -> np.ndarray:
    """pandas' bias-corrected rolling skew: 0 on a constant window, NaN
    where the variance is numerically zero (<= 1e-14) or n < 3."""
    n, B, C, _, flat = _moments(w)
    if n < 3:
        return np.full(w.shape[0], np.nan)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = math.sqrt(n * (n - 1.0)) * C / ((n - 2.0) * B ** 1.5)
    return np.where(flat, 0.0, np.where(B <= 1e-14, np.nan, g))


def _kurt(w: np.ndarray) -> np.ndarray:
    """pandas' bias-corrected rolling excess kurtosis: -3 on a constant
    window, NaN where the variance is numerically zero or n < 4."""
    n, B, _, D, flat = _moments(w)
    if n < 4:
        return np.full(w.shape[0], np.nan)
    with np.errstate(divide="ignore", invalid="ignore"):
        k = ((n * n - 1.0) * D / (B * B) - 3.0 * (n - 1.0) ** 2) \
            / ((n - 2.0) * (n - 3.0))
    return np.where(flat, -3.0, np.where(B <= 1e-14, np.nan, k))


def _mean_rolling_corr(r: np.ndarray, n: int) -> np.ndarray:
    """pandas' r.rolling(n).corr().groupby(level=0).mean().mean(axis=1):
    each day's A x A matrix of trailing-window correlations (diagonal
    included), averaged over its rows and then over the column means,
    both skipping NaN.  A column constant over the window has NaN
    correlations."""
    T, A = r.shape
    out = np.full(T, np.nan)
    if T < n:
        return out
    w = _windows(r, n)                                      # (W, n, A)
    d = w - w.mean(1, keepdims=True)
    cov = np.einsum("wni,wnj->wij", d, d)
    var = np.where(w.max(1) == w.min(1), 0.0,
                   np.diagonal(cov, axis1=1, axis2=2))      # (W, A)
    with np.errstate(divide="ignore", invalid="ignore"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)     # all-NaN rows
        corr = cov / np.sqrt(var[:, :, None] * var[:, None, :])
        corr = np.where((var[:, :, None] == 0) | (var[:, None, :] == 0),
                        np.nan, corr)
        col = np.nanmean(corr, axis=1)                      # (W, A)
        out[n - 1:] = np.nanmean(col, axis=1)
    return out


def prepare_regime_features(returns: np.ndarray,
                            lookback: int = 20) -> np.ndarray:
    """Engineered raw feature matrix from a (T, A) return panel, one row
    per input day (reference: train_simple.py:63-100's recipe): level,
    dispersion, momentum and downside statistics across rolling windows,
    13 columns in the JAX package's order.

    Alignment contract: len(output) == len(returns); warm-up and
    degenerate-window NaNs and +-inf become 0, rows are never dropped.
    Normalisation is not done here: SimpleRegimeDetector learns it at
    fit()."""
    r = np.asarray(returns, np.float64)
    T, A = r.shape
    m = r.mean(axis=1)
    cum = np.cumsum(m)
    with np.errstate(invalid="ignore", divide="ignore"):
        dispersion = r.std(axis=1, ddof=1) if A > 1 else np.full(T, np.nan)
    feats = np.stack([
        m,
        _rolling(m, lookback, _std),
        _rolling(m, lookback, _skew),
        _rolling(m, lookback, _kurt),
        _rolling(m, 5, lambda w: w.sum(1)),
        # fixed 20-day momentum whatever the lookback
        _rolling(m, 20, lambda w: w.sum(1)),
        _rolling(np.minimum(m, 0.0), lookback, _std),
        dispersion,
        _mean_rolling_corr(r, lookback) if A > 1 else m * 0,
        np.maximum.accumulate(cum) - cum,
        _rolling((m > 0).astype(np.float64), lookback, lambda w: w.mean(1)),
        _rolling(np.abs(m), lookback, lambda w: w.mean(1)),
        _rolling(m, 5, lambda w: w.max(1) - w.min(1)),
    ], axis=1)
    return np.nan_to_num(feats.astype(np.float32), nan=0.0, posinf=0.0,
                         neginf=0.0)
