"""The port's VAEHMM (vqvaehmm_tpu_torch) against the JAX VAEHMM on the same
parameters and inputs: every public method to <= 1e-4, the repo's parity
bar, plus weight interchange between the two packages."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import close, inputs, model_pair, t
from vqvaehmm_tpu_torch import ModelConfig, VAEHMM
from vqvaehmm_tpu_torch.data.checkpoint import (load_params_npz,
                                                load_state_dict_file,
                                                params_from_numpy,
                                                params_to_numpy,
                                                validate_params_for)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUBLISHED = os.path.join(ROOT, "artifacts", "checkpoints_published")


def _valid_to(kind, T, lengths):
    return {"none": None, "scalar": int(T) - 5, "vector": lengths}[kind]


@pytest.mark.parametrize("kind", ["none", "scalar", "vector"])
def test_encode_decode_infer_forward_match_jax(kind):
    jm, params, tm = model_pair(seed=1)
    x, _, lengths = inputs(3, 37, seed=2)
    vt = _valid_to(kind, 37, lengths)
    jvt = None if vt is None else jnp.asarray(vt)
    tvt = None if vt is None else t(vt) if kind == "vector" else vt
    with torch.no_grad():
        close(tm.encode(t(x), valid_to=tvt),
              jm.encode(params, jnp.asarray(x), valid_to=jvt), 1e-4,
              "encode")
        q = np.random.default_rng(3).dirichlet(np.ones(3), size=(3, 37))
        q = np.ascontiguousarray(q.transpose(0, 2, 1), dtype=np.float32)
        for g, w, name in zip(tm.decode(t(q), valid_to=tvt),
                              jm.decode(params, jnp.asarray(q),
                                        valid_to=jvt), ("mu", "logvar")):
            close(g, w, 1e-4, f"decode {name}")
        got = tm.infer_forward(t(x), valid_to=tvt)
    want = jm.infer_forward(params, jnp.asarray(x), valid_to=jvt,
                            use_pallas=False)
    for g, w, name in zip(got, want, ("mu", "logvar", "q")):
        close(g, w, 1e-4, f"infer_forward {name}")


@pytest.mark.parametrize("layout", ["BUT", "BTU"])
def test_prior_matches_jax(layout):
    jm, params, tm = model_pair(seed=4)
    _, u, _ = inputs(2, 29, seed=5)
    if layout == "BTU":
        u = np.ascontiguousarray(u.transpose(0, 2, 1))
    with torch.no_grad():
        got = tm.prior(t(u))
    want = jm.prior(params, jnp.asarray(u))
    close(got[0], want[0], 1e-5, "log_pi")
    close(got[1], want[1], 1e-5, "log_A")


@pytest.mark.parametrize("beta", [0.0, 0.37, 1.0])
def test_compute_loss_matches_jax(beta):
    jm, params, tm = model_pair(seed=6)
    x, u, lengths = inputs(4, 37, seed=7)
    with torch.no_grad():
        got = float(tm.compute_loss(t(x), t(u), t(lengths), beta))
    want = float(jm.compute_loss(params, jnp.asarray(x), jnp.asarray(u),
                                 jnp.asarray(lengths), beta))
    assert abs(got - want) <= 1e-4 * max(1.0, abs(want))


def test_forward_and_posterior_match_jax():
    jm, params, tm = model_pair(seed=8)
    x, _, _ = inputs(2, 40, seed=9)
    with torch.no_grad():
        (mu, logvar), q = tm(t(x))
        post = tm.posterior(t(x))
    (jmu, jlogvar), jq = jm(params, jnp.asarray(x))
    for g, w in ((mu, jmu), (logvar, jlogvar), (q, jq)):
        close(g, w, 1e-4)
    close(post, jm.posterior(params, jnp.asarray(x), fused=False), 1e-5)


def test_reference_pt_loads_natively():
    """The reference-format .pt loads straight into the port's modules and
    serves what JAX serves after its own state_dict mapping."""
    from vqvaehmm_tpu.core.config import load_config
    from vqvaehmm_tpu.models.vae_hmm import VAEHMM as JaxVAEHMM
    from vqvaehmm_tpu.utils.torch_interop import (
        load_torch_file, vae_hmm_params_from_state_dict)

    path = os.path.join(PUBLISHED, "vae_hmm.pt")
    cfg = load_config(os.path.join(ROOT, "artifacts",
                                   "config_published.json")).model
    tm = VAEHMM(ModelConfig(**{f: getattr(cfg, f) for f in (
        "input_dim", "hidden_dim", "K", "hidden_dim2", "u_dim",
        "trans_hidden")}))
    tm.load_state_dict(load_state_dict_file(path))
    jm = JaxVAEHMM(cfg)
    params = vae_hmm_params_from_state_dict(load_torch_file(path))
    x, _, lengths = inputs(2, 40, seed=10)
    with torch.no_grad():
        got = tm.infer_forward(t(x), valid_to=t(lengths))
    want = jm.infer_forward(params, jnp.asarray(x),
                            valid_to=jnp.asarray(lengths), use_pallas=False)
    for g, w, name in zip(got, want, ("mu", "logvar", "q")):
        close(g, w, 1e-4, name)


def test_published_npz_loads_like_jax():
    from vqvaehmm_tpu.data.checkpoint import load_params_npz as jax_load

    path = os.path.join(PUBLISHED, "vae_hmm_trained.npz")
    ours, theirs = load_params_npz(path), jax_load(path)
    flat = params_from_numpy(ours)
    assert flat.keys() == params_from_numpy(theirs).keys()
    back = params_to_numpy(flat)
    for sec in theirs:
        for name in theirs[sec]:
            node = theirs[sec][name]
            leaves = node.items() if isinstance(node, dict) else [("", node)]
            for leaf, arr in leaves:
                got = back[sec][name][leaf] if leaf else back[sec][name]
                np.testing.assert_array_equal(got, arr)


def test_params_round_trip_and_validation():
    jm, params, tm = model_pair(seed=11)
    sd = tm.state_dict()
    tree = params_to_numpy(sd)
    again = params_from_numpy(tree)
    assert again.keys() == sd.keys()
    for k in sd:
        assert torch.equal(again[k], sd[k])
    # flat "/"-joined keys are accepted as well as nested dicts
    flat = {"encoder/conv1/weight": tree["encoder"]["conv1"]["weight"]}
    assert list(params_from_numpy(flat)) == ["encoder.conv1.weight"]
    with pytest.raises(KeyError):
        params_from_numpy({"encoder": {"conv9": {"weight": np.zeros(1)}}})
    validate_params_for(tm, again)
    bad = dict(again)
    bad["encoder.conv1.weight"] = torch.zeros(2, 2, 3)
    with pytest.raises(ValueError, match="encoder.conv1.weight"):
        validate_params_for(tm, bad)


def test_init_distribution_and_seed():
    cfg = ModelConfig(input_dim=5, hidden_dim=8, K=3, hidden_dim2=4,
                      u_dim=4, trans_hidden=8)
    a = VAEHMM(cfg, generator=torch.Generator().manual_seed(0))
    b = VAEHMM(cfg, generator=torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    bound = (1.0 / (5 * 3)) ** 0.5
    w = a.encoder.conv1.weight.detach()
    assert float(w.abs().max()) <= bound
    assert float(w.abs().max()) > 0.5 * bound
    assert torch.count_nonzero(a.prior_module.log_prior) == 0


def test_bf16_config_not_ported():
    cfg = ModelConfig(input_dim=5, hidden_dim=8, K=3, hidden_dim2=4,
                      u_dim=4, trans_hidden=8, compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VAEHMM(cfg)
