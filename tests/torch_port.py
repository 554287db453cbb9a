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


def write_serving_config(tmp, seed: int = 0, name: str = "cfg.json",
                         **extra) -> str:
    """A serving config for SMALL whose checkpoint is an `.npz` of the JAX
    package's init at `seed` (both packages' servers load it); `extra`
    adds or overrides top-level keys.  Returns the config's path."""
    import json

    from vqvaehmm_tpu.data.checkpoint import save_params_npz

    ckpt = tmp / f"model_{seed}.npz"
    save_params_npz(str(ckpt), make_model(**SMALL).init(
        jax.random.PRNGKey(seed)))
    cfg = {"model": SMALL, "checkpoint_path": str(ckpt), **extra}
    path = tmp / name
    path.write_text(json.dumps(cfg))
    return str(path)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def post_json(url, payload=None, headers=None, timeout=60):
    """(status, JSON body, response headers) of a POST; HTTP errors are
    returned, not raised."""
    import json
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps({} if payload is None else payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers


def jax_mc_draws(key, K: int, A: int, n_sim: int, n_days: int, p0=None):
    """The random numbers vqvaehmm_tpu.backtest.montecarlo.
    monte_carlo_simulation draws from `key`, split exactly as it splits
    its keys (a key a path, split into the first regime's and the days';
    a key a day, split into the switch uniform's, the new regime's and the
    normals'), in the layout of the port's monte_carlo_draws: numpy z0
    (n_sim,), u_switch (n_sim, n_days), z_new (n_sim, n_days), eps (n_sim,
    n_days, A)."""
    import jax.numpy as jnp

    logp0 = jnp.log(jnp.asarray(np.full(K, 1.0 / K) if p0 is None
                                else np.asarray(p0), jnp.float32))

    def day(key_t):
        ks, kz, kn = jax.random.split(key_t, 3)
        return (jax.random.uniform(ks), jax.random.randint(kz, (), 0, K),
                jax.random.normal(kn, (A,)))

    def path(k):
        k0, kr = jax.random.split(k)
        return (jax.random.categorical(k0, logp0),
                *jax.vmap(day)(jax.random.split(kr, n_days)))

    z0, u, zn, eps = jax.vmap(path)(jax.random.split(key, n_sim))
    return {"z0": np.array(z0), "u_switch": np.array(u),
            "z_new": np.array(zn), "eps": np.array(eps)}
