"""The port's exact HMM inference (vqvaehmm_tpu_torch/ops/hmm.py and the
model's smoothed/filtered posteriors) against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.torch_port import close, hmm_inputs, inputs, model_pair, t
from vqvaehmm_tpu.ops import hmm as jax_hmm
from vqvaehmm_tpu_torch.ops import hmm as port_hmm


@pytest.mark.parametrize("ndim,ragged", [(4, True), (3, True), (2, False)])
def test_marginals_and_likelihood_match_jax(ndim, ragged):
    log_pi, log_A, log_obs, lengths = hmm_inputs(3, 30, 3, seed=ndim)
    log_A = {4: log_A, 3: log_A[0], 2: log_A[0, 0]}[ndim]
    lens = lengths if ragged else None
    jargs = [jnp.asarray(a) for a in (log_pi, log_A, log_obs)]
    targs = [t(a) for a in (log_pi, log_A, log_obs)]
    jl = None if lens is None else jnp.asarray(lens)
    tl = None if lens is None else t(lens)
    fwd, jfwd = port_hmm.forward(*targs, tl), jax_hmm.forward(*jargs, jl)
    close(fwd.log_alpha, jfwd.log_alpha, 1e-4, "log_alpha")
    close(fwd.log_likelihood, jfwd.log_likelihood, 1e-4, "likelihood")
    close(port_hmm.backward(*targs[1:], tl),
          jax_hmm.backward(*jargs[1:], jl), 1e-4, "log_beta")
    close(port_hmm.posterior_marginals(*targs, tl),
          jax_hmm.posterior_marginals(*jargs, jl), 1e-5, "smoothed")
    close(port_hmm.filtered_marginals(*targs, tl),
          jax_hmm.filtered_marginals(*jargs, jl), 1e-5, "filtered")


def test_model_posteriors_match_jax():
    import torch

    jm, params, tm = model_pair(seed=14)
    x, u, lengths = inputs(3, 35, seed=15)
    with torch.no_grad():
        sm = tm.smoothed_posterior(t(x), t(u), t(lengths))
        fi = tm.filtered_posterior(t(x), t(u), t(lengths))
    args = (params, jnp.asarray(x), jnp.asarray(u), jnp.asarray(lengths))
    close(sm, jm.smoothed_posterior(*args, use_pallas=False), 1e-4,
          "smoothed")
    close(fi, jm.filtered_posterior(*args, use_pallas=False), 1e-4,
          "filtered")
    assert np.allclose(sm.sum(1).numpy(), 1.0, atol=1e-5)


def _brute_force(log_pi, log_A, log_obs):
    """Enumerate every path of one short sequence: (log-likelihood, gamma
    (T, K), xi (T-1, K, K), best path score), in float64."""
    import itertools

    T, K = log_obs.shape
    paths = np.array(list(itertools.product(range(K), repeat=T)))
    lp = log_pi[paths[:, 0]] + log_obs[0, paths[:, 0]]
    for k in range(1, T):
        lp = lp + log_A[k, paths[:, k - 1], paths[:, k]] \
            + log_obs[k, paths[:, k]]
    ll = np.logaddexp.reduce(lp)
    w = np.exp(lp - ll)
    gamma = np.zeros((T, K))
    xi = np.zeros((T - 1, K, K))
    for k in range(T):
        np.add.at(gamma[k], paths[:, k], w)
    for k in range(T - 1):
        np.add.at(xi[k], (paths[:, k], paths[:, k + 1]), w)
    return ll, gamma, xi, lp.max()


@pytest.mark.parametrize("ragged", [True, False])
def test_smoothing_and_pairwise_match_jax_and_enumeration(ragged):
    """gamma, xi and the likelihood within 1e-4 of the JAX package, and of
    the enumeration of all K^T paths on each row's valid prefix."""
    import torch

    log_pi, log_A, log_obs, lengths = hmm_inputs(3, 6, 3, seed=21)
    lens = lengths if ragged else None
    jl = None if lens is None else jnp.asarray(lens)
    tl = None if lens is None else t(lens)
    targs = [t(a) for a in (log_pi, log_A, log_obs)]
    jargs = [jnp.asarray(a) for a in (log_pi, log_A, log_obs)]
    got = port_hmm.smoothing(*targs, tl)
    want = jax_hmm.smoothing(*jargs, jl)
    for g, w, name in zip(got, want, got._fields):
        close(g, w, 1e-4, name)
    assert torch.equal(port_hmm.pairwise_marginals(*targs, tl), got.xi)
    for b in range(3):
        L = 6 if lens is None else int(lens[b])
        ll, gamma, xi, _ = _brute_force(
            log_pi.astype(np.float64), log_A[b, :L].astype(np.float64),
            log_obs[b, :L].astype(np.float64))
        assert abs(float(got.log_likelihood[b]) - ll) <= 1e-4
        close(got.gamma[b, :L], gamma, 1e-4, "gamma vs enumeration")
        close(got.xi[b, :L - 1], xi, 1e-4, "xi vs enumeration")
        # pairs past the length are zeroed, not identity transitions
        assert not got.xi[b, max(L - 1, 0):].any()


@pytest.mark.parametrize("T,ragged", [(1, False), (6, True), (13, False)])
def test_associative_forms_match_jax_and_the_recursions(T, ragged):
    """forward_assoc and viterbi_assoc_scores within 1e-4 of the JAX
    package's associative scans and of the port's sequential forms."""
    log_pi, log_A, log_obs, lengths = hmm_inputs(3, T, 3, seed=T)
    lens = lengths if ragged else None
    jl = None if lens is None else jnp.asarray(lens)
    tl = None if lens is None else t(lens)
    targs = [t(a) for a in (log_pi, log_A, log_obs)]
    jargs = [jnp.asarray(a) for a in (log_pi, log_A, log_obs)]
    fa = port_hmm.forward_assoc(*targs, tl)
    deltas, score = port_hmm.viterbi_assoc_scores(*targs, tl)
    assert tuple(fa.log_alpha.shape) == tuple(deltas.shape) == (3, T, 3)
    if T > 1:          # the JAX scans take at least one operator
        jfa = jax_hmm.forward_assoc(*jargs, jl)
        close(fa.log_alpha, jfa.log_alpha, 1e-4, "log_alpha")
        close(fa.log_likelihood, jfa.log_likelihood, 1e-4, "likelihood")
        jd, js = jax_hmm.viterbi_assoc_scores(*jargs, jl)
        close(deltas, jd, 1e-4, "deltas")
        close(score, js, 1e-4, "score")
    seq = port_hmm.forward(*targs, tl)
    close(fa.log_alpha, seq.log_alpha, 1e-4, "assoc vs recursion")
    close(score, port_hmm.viterbi(*targs, tl).score, 1e-4, "MAP score")
    if T == 6:
        for b in range(3):
            L = int(lens[b])
            best = _brute_force(log_pi.astype(np.float64),
                                log_A[b, :L].astype(np.float64),
                                log_obs[b, :L].astype(np.float64))[3]
            assert abs(float(score[b]) - best) <= 1e-4


def test_sample_follows_the_chain():
    """Paths drawn from an explicit generator: reproducible from the seed,
    the first state distributed as pi and each transition as its row of A
    (4096 paths; frequencies within 0.04, about 5 standard errors)."""
    import torch

    rng = np.random.default_rng(5)
    K, T, N = 3, 4, 4096
    log_pi = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    log_A = np.log(rng.dirichlet(np.ones(K), size=(T, K))).astype(np.float32)
    draw = lambda seed: port_hmm.sample(                    # noqa: E731
        torch.Generator().manual_seed(seed), t(log_pi), t(log_A), T, batch=N)
    z = draw(0)
    assert z.dtype == torch.int32 and tuple(z.shape) == (N, T)
    assert torch.equal(z, draw(0)) and not torch.equal(z, draw(1))
    z = z.numpy()
    assert z.min() >= 0 and z.max() < K
    freq0 = np.bincount(z[:, 0], minlength=K) / N
    np.testing.assert_allclose(freq0, np.exp(log_pi), atol=0.04)
    for step in range(1, T):
        for i in range(K):
            rows = z[z[:, step - 1] == i, step]
            if len(rows) > 400:
                np.testing.assert_allclose(
                    np.bincount(rows, minlength=K) / len(rows),
                    np.exp(log_A[step, i]),
                    atol=0.04 * np.sqrt(N / len(rows)))
    # a stationary (K, K) matrix and batch=1 are accepted too
    one = port_hmm.sample(torch.Generator().manual_seed(2), t(log_pi),
                          t(log_A[0]), 9)
    assert tuple(one.shape) == (1, 9)
