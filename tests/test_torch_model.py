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


def test_bf16_config_builds():
    """A bfloat16 config builds; its parameters are float32 and the model
    reads compute_dtype (an unknown dtype raises)."""
    cfg = ModelConfig(input_dim=5, hidden_dim=8, K=3, hidden_dim2=4,
                      u_dim=4, trans_hidden=8, compute_dtype="bfloat16")
    m = VAEHMM(cfg)
    assert m.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in m.parameters())
    x = torch.randn(2, 5, 16)
    assert m.encode(x, fused=False).dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        VAEHMM(ModelConfig(**{**cfg.__dict__, "compute_dtype": "float16"}))


def test_improved_head_matches_jax():
    """The stacked per-regime bank on shared weights, <= 1e-5, for (B, K)
    and (B, K, T) inputs; the committed head checkpoint loads into it."""
    import jax

    from vqvaehmm_tpu.models.portfolio import HeadConfig as JaxHeadConfig
    from vqvaehmm_tpu.models.portfolio import \
        ImprovedPortfolioOptimizer as JaxHead
    from vqvaehmm_tpu_torch.data.checkpoint import (
        improved_head_params_from_numpy, load_improved_head)
    from vqvaehmm_tpu_torch.models import (HeadConfig,
                                           ImprovedPortfolioOptimizer)

    jhead = JaxHead(JaxHeadConfig(K=3, n_assets=7, hidden_dim=16))
    params = jhead.init(jax.random.PRNGKey(3))
    thead = ImprovedPortfolioOptimizer(HeadConfig(K=3, n_assets=7,
                                                  hidden_dim=16)).eval()
    thead.load_state_dict(improved_head_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params)))
    q = np.random.default_rng(4).dirichlet(np.ones(3), size=(5, 11))
    q = np.ascontiguousarray(q.transpose(0, 2, 1), dtype=np.float32)
    with torch.no_grad():
        close(thead(t(q)), jhead(params, jnp.asarray(q)), 1e-5, "(B, K, T)")
        close(thead(t(q[:, :, 3])), jhead(params, jnp.asarray(q[:, :, 3])),
              1e-5, "(B, K)")
    with pytest.raises(KeyError, match="stacked"):
        improved_head_params_from_numpy({"fc1": {"weight": np.zeros((4, 3)),
                                                 "bias": np.zeros(4)}})
    path = os.path.join(ROOT, "artifacts", "portfolio_head.npz")
    from vqvaehmm_tpu.data.checkpoint import load_params_npz as jax_load

    loaded = load_improved_head(path, device="cpu")
    big = JaxHead(JaxHeadConfig(K=3, n_assets=10, hidden_dim=64))
    hp = jax.tree_util.tree_map(jnp.asarray, jax_load(path))
    with torch.no_grad():
        w = loaded(t(q))
    close(w, big(hp, jnp.asarray(q)), 1e-5, "portfolio_head.npz")
    assert not loaded.training and np.allclose(w.sum(-1).numpy(), 1.0,
                                               atol=1e-5)


def test_improved_head_dropout_only_in_train_mode():
    """eval() is deterministic; train() draws its masks from the generator
    it is given: the same seed gives the same output, and about a fifth of
    the hidden units are dropped."""
    from vqvaehmm_tpu_torch.models import (HeadConfig,
                                           ImprovedPortfolioOptimizer)

    head = ImprovedPortfolioOptimizer(
        HeadConfig(K=3, n_assets=5, hidden_dim=256),
        generator=torch.Generator().manual_seed(0))
    q = torch.softmax(torch.randn((64, 3),
                                  generator=torch.Generator().manual_seed(1)),
                      dim=1)
    with torch.no_grad():
        head.eval()
        base = head(q)
        assert torch.equal(base, head(q, torch.Generator().manual_seed(9)))
        head.train()
        with pytest.raises(ValueError, match="Generator"):
            head(q)
        a = head(q, torch.Generator().manual_seed(5))
        b = head(q, torch.Generator().manual_seed(5))
        c = head(q, torch.Generator().manual_seed(6))
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert not torch.equal(a, base)
        kept = head._drop(torch.ones((3, 64, 256)),
                          torch.Generator().manual_seed(7))
    frac = float((kept == 0).float().mean())
    assert abs(frac - 0.2) < 0.01
    assert torch.allclose(kept[kept != 0], torch.tensor(1.25))
    assert np.allclose(a.sum(-1).numpy(), 1.0, atol=1e-5)


def test_posterior_and_exact_modes_dispatch_on_cpu():
    """posterior(fused=...) and the exact modes through fused_evidence on
    CPU tensors: the plain versions, equal to the JAX package's."""
    from vqvaehmm_tpu_torch.ops.fused_decode import fused_evidence

    jm, params, tm = model_pair(seed=12)
    x, u, lengths = inputs(3, 33, seed=13)
    jargs = (params, jnp.asarray(x), jnp.asarray(u), jnp.asarray(lengths))
    with torch.no_grad():
        post = tm.posterior(t(x))
        assert torch.equal(post, tm.posterior(t(x), fused=False))
        with pytest.raises(ValueError, match="CUDA"):
            tm.posterior(t(x), fused=True)
        log_pi, log_A, log_obs = tm._evidence_inputs(t(x), t(u), t(lengths),
                                                     None)
        for g, w in zip((log_pi, log_A, log_obs),
                        fused_evidence(tm, t(x), t(u), t(lengths))):
            assert torch.equal(g, w)
        states = tm.viterbi_decode(t(x), t(u), t(lengths))
    close(post, jm.posterior(params, jnp.asarray(x), fused=False), 1e-5)
    jpi, jA = jm.prior(params, jnp.asarray(u))
    close(log_pi, jpi, 1e-5, "log_pi")
    close(log_A, jA, 1e-5, "log_A")
    close(log_obs, jm._hmm_evidence(params, jnp.asarray(x),
                                    jnp.asarray(lengths)), 1e-5, "log_obs")
    want = np.asarray(jm.viterbi_decode(*jargs, use_pallas=False))
    for b in range(3):
        np.testing.assert_array_equal(states[b, :lengths[b]].numpy(),
                                      want[b, :lengths[b]])


def test_model_sample_decodes_the_drawn_path():
    _, _, tm = model_pair(seed=14)
    _, u, _ = inputs(4, 25, seed=15)
    with torch.no_grad():
        states, mean = tm.sample(t(u), torch.Generator().manual_seed(0),
                                 sample_obs=False)
        again, x = tm.sample(t(u), torch.Generator().manual_seed(0))
        q = torch.nn.functional.one_hot(states.long(), 3).float()
        mu, logvar = tm.decode(q.transpose(1, 2))
    assert states.dtype == torch.int32 and tuple(states.shape) == (4, 25)
    assert torch.equal(states, again)
    assert torch.equal(mean, mu) and tuple(x.shape) == (4, 5, 25)
    # a draw scatters about the emission mean by the emission's deviation
    z = ((x - mu) / torch.exp(0.5 * logvar)).numpy()
    assert abs(z.mean()) < 0.2 and 0.8 < z.std() < 1.2
