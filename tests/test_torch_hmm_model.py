"""The port's stationary HMM and its EM fits
(vqvaehmm_tpu_torch/models/hmm.py) on the CPU against the JAX package's
models/hmm.py on the same numpy inputs: reals to <= 1e-4 absolute
(float32, other summation orders), log-likelihoods to <= 1e-4 relative,
integers equal (a decoded path may differ only where its score ties).
The EM fits start from JAX's own initial draws, re-derived here from
jax.random with the keys the JAX functions split."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, t
from vqvaehmm_tpu.models import hmm as jhmm
from vqvaehmm_tpu_torch.models import hmm as thmm

ATOL = 1e-4
K, V = 3, 6


def _chain(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.dirichlet(np.ones(K)).astype(np.float32),
            rng.dirichlet(np.ones(K), size=K).astype(np.float32))


def _pair(emission: str, seed=0, D=1):
    """(jax model, torch model) over one set of numpy parameters."""
    rng = np.random.default_rng(seed + 100)
    pi, A = _chain(seed)
    if emission == "categorical":
        logits = rng.normal(size=(K, V)).astype(np.float32)
        je = jhmm.CategoricalEmission(jnp.asarray(logits))
        te = thmm.CategoricalEmission(t(logits))
    else:
        shape = (K,) if D == 1 else (K, D)
        loc = rng.normal(size=shape).astype(np.float32)
        scale = (0.5 + rng.random(size=shape)).astype(np.float32)
        je = jhmm.GaussianEmission(jnp.asarray(loc), jnp.asarray(scale))
        te = thmm.GaussianEmission(t(loc), t(scale))
    return (jhmm.HiddenMarkovModel(pi, A, je, num_steps=9),
            thmm.HiddenMarkovModel(pi, A, te, num_steps=9))


def _obs(emission: str, B=4, T=23, D=1, seed=1):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, 5, 17, 11][:B], np.int32)
    if emission == "categorical":
        return rng.integers(0, V, size=(B, T)).astype(np.int32), lengths
    shape = (B, T) if D == 1 else (B, T, D)
    return rng.normal(size=shape).astype(np.float32), lengths


def _path_score(model, log_obs, states, L):
    s = states[:L]
    score = model.log_pi[s[0]] + log_obs[0, s[0]]
    for i in range(1, L):
        score = score + model.log_A[s[i - 1], s[i]] + log_obs[i, s[i]]
    return float(score)


@pytest.mark.parametrize("emission,D", [("categorical", 1), ("gaussian", 1),
                                        ("gaussian", 3)])
def test_inference_matches_jax(emission, D):
    jm, tm = _pair(emission, D=D)
    x, lengths = _obs(emission, D=D)
    close(tm.state_marginals(), jm.state_marginals(), ATOL)
    close(tm.mean(), jm.mean(), ATOL)
    close(tm.mean(5), jm.mean(5), ATOL)
    for lens in (None, lengths):
        jl = None if lens is None else jnp.asarray(lens)
        tl = None if lens is None else t(lens)
        want = np.asarray(jm.log_prob(jnp.asarray(x), jl))
        got = tm.log_prob(t(x), tl).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)
        close(tm.posterior_marginals(t(x), tl),
              jm.posterior_marginals(jnp.asarray(x), jl), ATOL)
        gs = tm.posterior_mode(t(x), tl)
        ws = np.asarray(jm.posterior_mode(jnp.asarray(x), jl,
                                          use_pallas=False))
        assert gs.dtype == torch.int32 and gs.shape == ws.shape
        assert torch.equal(gs, tm.posterior_mode(t(x), tl, use_kernel=False))
        log_obs = tm.emission.log_prob(t(x))
        for b in range(x.shape[0]):
            L = x.shape[1] if lens is None else int(lens[b])
            if not np.array_equal(gs[b, :L].numpy(), ws[b, :L]):
                # two paths may part only on a tie of their scores
                a = _path_score(tm, log_obs[b], gs[b].long(), L)
                w = _path_score(tm, log_obs[b], t(ws[b]).long(), L)
                assert abs(a - w) <= 1e-4 * max(1.0, abs(w))
    # an unbatched sequence
    close(tm.log_prob(t(x[0])), jm.log_prob(jnp.asarray(x[0])), 1e-3)
    assert tm.posterior_mode(t(x[0])).shape == (x.shape[1],)
    with pytest.raises(ValueError, match="CUDA"):
        tm.posterior_mode(t(x), use_kernel=True)


def test_sample_shapes_and_ranges():
    for emission in ("categorical", "gaussian"):
        _, tm = _pair(emission)
        g = torch.Generator().manual_seed(0)
        states, obs = tm.sample(g, num_steps=12, batch=5)
        assert states.shape == (5, 12) and obs.shape == (5, 12)
        assert states.dtype == torch.int32
        assert 0 <= int(states.min()) and int(states.max()) < K
        if emission == "categorical":
            assert 0 <= int(obs.min()) and int(obs.max()) < V
        else:
            assert torch.isfinite(obs).all()
        again = tm.sample(torch.Generator().manual_seed(0), 12, 5)
        assert torch.equal(states, again[0]) and torch.equal(obs, again[1])
    assert tm.sample(torch.Generator().manual_seed(1))[0].shape == (1, 9)


def _non_decreasing(lls, slack=1e-4):
    lls = np.asarray(lls, np.float64)
    return bool((np.diff(lls) >= -slack * np.abs(lls[:-1])).all())


@pytest.mark.parametrize("sticky", [None, 0.95])
def test_fit_categorical_em_follows_jax(sticky):
    n_iters, n_init, seed = 8, 3, 5
    rng = np.random.default_rng(2)
    codes = rng.integers(0, V, size=(5, 30)).astype(np.int32)
    codes[:, 10:20] = codes[:, 10:20] % 2          # some structure to fit
    lengths = np.array([30, 12, 30, 21, 7], np.int32)
    want = jhmm.fit_categorical_em(jnp.asarray(codes), K, V, n_iters, seed,
                                   jnp.asarray(lengths), n_init=n_init,
                                   sticky=sticky)
    # the restarts' draws, with the keys of fit_categorical_em
    draws = []
    for key in jax.random.split(jax.random.PRNGKey(seed), n_init):
        k1, k2, k3 = jax.random.split(key, 3)
        draws.append((
            jnp.log(jax.random.dirichlet(k1, jnp.ones(K))),
            jnp.log(jax.random.dirichlet(k2, jnp.full(K, 2.0), shape=(K,))),
            jnp.log(jax.random.dirichlet(k3, jnp.ones(V), shape=(K,)))))
    init = tuple(np.stack([np.asarray(d[i]) for d in draws])
                 for i in range(3))
    got = thmm.fit_categorical_em(t(codes), K, V, n_iters, seed, t(lengths),
                                  n_init=n_init, sticky=sticky, init=init)
    np.testing.assert_allclose(got.log_likelihoods.numpy(),
                               np.asarray(want.log_likelihoods), rtol=1e-4)
    assert _non_decreasing(got.log_likelihoods)
    close(got.model.log_pi, want.model.log_pi, 1e-3)
    close(torch.exp(got.model.log_A), jnp.exp(want.model.log_A), 1e-3)
    close(torch.exp(got.model.emission.logits),
          jnp.exp(want.model.emission.logits), 1e-3)
    assert got.model.K == K and got.model.num_steps == 30

    # without `init` the draws come from numpy: a fit of its own
    own = thmm.fit_categorical_em(t(codes), K, V, 4, seed, t(lengths),
                                  n_init=2, sticky=sticky)
    assert _non_decreasing(own.log_likelihoods)
    close(torch.exp(own.model.emission.logits).sum(-1), np.ones(K), 1e-5)


def test_fit_transitions_em_follows_jax():
    rng = np.random.default_rng(3)
    log_obs = (2.0 * rng.normal(size=(4, 25, K))).astype(np.float32)
    lengths = np.array([25, 9, 25, 16], np.int32)
    for lens in (None, lengths):
        jl = None if lens is None else jnp.asarray(lens)
        tl = None if lens is None else t(lens)
        want = jhmm.fit_transitions_em(jnp.asarray(log_obs), 7, jl)
        got = thmm.fit_transitions_em(t(log_obs), 7, tl)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=1e-4)
        assert _non_decreasing(got[2])
        close(got[0], want[0], 1e-3)
        close(torch.exp(got[1]), jnp.exp(want[1]), 1e-3)


@pytest.mark.parametrize("D", [1, 2])
def test_fit_gaussian_em_follows_jax(D):
    n_iters, n_init, seed = 6, 2, 7
    rng = np.random.default_rng(4)
    means = np.array([-2.0, 0.0, 2.5], np.float32)
    z = rng.integers(0, K, size=(4, 28))
    x = (means[z][..., None] + 0.5 * rng.normal(size=(4, 28, D))
         ).astype(np.float32)
    if D == 1:
        x = x[..., 0]
    lengths = np.array([28, 28, 13, 20], np.int32)
    want = jhmm.fit_gaussian_em(jnp.asarray(x), K, n_iters, seed,
                                jnp.asarray(lengths), n_init=n_init)
    # the restarts' draws, with the keys and the data moments of
    # fit_gaussian_em
    xf = jnp.asarray(x).reshape(4, 28, D)
    vf = (jnp.arange(28)[None, :] < jnp.asarray(lengths)[:, None]
          ).astype(jnp.float32).reshape(-1, 1)
    flat = xf.reshape(-1, D)
    mean = (flat * vf).sum(0) / vf.sum()
    std = jnp.sqrt(((flat - mean) ** 2 * vf).sum(0) / vf.sum())
    draws = []
    for key in jax.random.split(jax.random.PRNGKey(seed), n_init):
        k1, k2, k3 = jax.random.split(key, 3)
        draws.append((
            jnp.log(jax.random.dirichlet(k1, jnp.ones(K))),
            jnp.log(jax.random.dirichlet(k2, jnp.full(K, 2.0), shape=(K,))),
            mean + std * jax.random.normal(k3, (K, D))))
    init = tuple(np.stack([np.asarray(d[i]) for d in draws])
                 for i in range(3))
    got = thmm.fit_gaussian_em(t(x), K, n_iters, seed, t(lengths),
                               n_init=n_init, init=init)
    np.testing.assert_allclose(got.log_likelihoods.numpy(),
                               np.asarray(want.log_likelihoods), rtol=1e-4)
    assert _non_decreasing(got.log_likelihoods)
    assert got.model.emission.loc.shape == ((K,) if D == 1 else (K, D))
    close(got.model.emission.loc, want.model.emission.loc, 1e-3)
    close(got.model.emission.scale, want.model.emission.scale, 1e-3)

    own = thmm.fit_gaussian_em(t(x), K, 3, seed, t(lengths), n_init=2)
    assert torch.isfinite(own.log_likelihoods).all()
