"""Shared set-up for the parity tests of the PyTorch port
(tests/test_torch_*.py): one set of numpy parameters, made by the JAX
package's init, loaded into both packages."""

import jax
import numpy as np
import torch

from vqvaehmm_tpu import make_model
from vqvaehmm_tpu_torch import VAEHMM, ModelConfig
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy

# the suite runs under xdist with several workers: one thread each
torch.set_num_threads(1)

SMALL = dict(input_dim=5, hidden_dim=8, K=3, hidden_dim2=4, u_dim=4,
             trans_hidden=8)


def model_pair(seed: int = 0, **overrides):
    """(jax_model, jax_params, torch_model) sharing one parameter set."""
    cfg = {**SMALL, **overrides}
    jm = make_model(**cfg)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = VAEHMM(ModelConfig(**cfg))
    tm.load_state_dict(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm.eval()


def inputs(B: int, T: int, seed: int = 0, C: int = 5, U: int = 4):
    """(x, u, lengths) as numpy: non-zero everywhere (tails included),
    ragged lengths with one full-length row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    u = rng.normal(size=(B, U, T)).astype(np.float32)
    lengths = rng.integers(T // 3, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return x, u, lengths


def hmm_inputs(B: int, T: int, K: int, seed: int = 0):
    """(log_pi, log_A (B,T,K,K), log_obs (B,T,K), lengths) as numpy."""
    rng = np.random.default_rng(seed)
    log_pi = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    log_A = np.log(rng.dirichlet(np.ones(K), size=(B, T, K))
                   ).astype(np.float32)
    log_obs = (2.0 * rng.normal(size=(B, T, K))).astype(np.float32)
    lengths = rng.integers(T // 3, T + 1, size=B).astype(np.int32)
    lengths[0] = T
    return log_pi, log_A, log_obs, lengths


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)
