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
