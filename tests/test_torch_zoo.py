"""The rest of the downstream zoo on the CPU: the six portfolio heads of
vqvaehmm_tpu_torch/models/portfolio.py (attention, transformer, Bayesian,
ensemble, hierarchical, LSTM), the attention layers of ops/attention.py,
and the models and utilities of models/regime.py, each against its JAX
counterpart on the same numpy inputs with JAX's parameters carried across
by data/checkpoint.py::zoo_params_from_numpy.  Values and gradients within
1e-4 absolute (1e-5 where stated), both input layouts, train() and eval()
modes for the attention layers, JAX's refusals, the Bayesian head on
JAX's own draws, the LSTM models' square-input trap, and the Gradio
demo's head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vqvaehmm_tpu.models.portfolio as jp
import vqvaehmm_tpu.models.regime as jr
import vqvaehmm_tpu_torch.models.portfolio as tp
import vqvaehmm_tpu_torch.models.regime as tr
from tests.torch_port import close, t
from vqvaehmm_tpu_torch.data.checkpoint import zoo_params_from_numpy

K, A, H, B, T = 3, 4, 8, 5, 7


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _carry(module, params):
    """Load JAX's params into the port's module (keys and shapes checked)."""
    module.load_state_dict(zoo_params_from_numpy(_np_tree(params), module))
    return module


def _probs(rng, *shape):
    """Regime probabilities over the last axis."""
    return rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]) \
        .astype(np.float32)


def _head_pair(name, k=K, **kw):
    cfg = (k, A, H)
    jcls, tcls = getattr(jp, name), getattr(tp, name)
    jm = jcls(jp.HeadConfig(*cfg), **kw)
    params = jm.init(jax.random.PRNGKey(3))
    tm = _carry(tcls(tp.HeadConfig(*cfg), **kw,
                     generator=torch.Generator().manual_seed(0)), params)
    return jm, params, tm


POINTWISE = ["BayesianPortfolioOptimizer", "EnsemblePortfolioOptimizer",
             "HierarchicalPortfolioOptimizer"]
SEQUENCE = ["AttentionPortfolioOptimizer", "TransformerPortfolioOptimizer",
            "RegimeLSTMOptimizer"]


def _layouts(name, rng):
    """The inputs a head takes: (B, K) and (B, K, T) for every head, and
    (B, T, K) for the sequence heads (not the LSTM head's (B, K))."""
    q_kt = _probs(rng, B, T, K).transpose(0, 2, 1).copy()
    out = {"(B, K, T)": q_kt}
    if name != "RegimeLSTMOptimizer":
        out["(B, K)"] = _probs(rng, B, K)
    if name in SEQUENCE:
        out["(B, T, K)"] = q_kt.transpose(0, 2, 1).copy()
    return out


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", POINTWISE + SEQUENCE)
def test_head_matches_jax(name, mode):
    """Every input layout, the weights and the gradients of a weighted sum
    of them with respect to every parameter, train() and eval() mode
    (torch's attention layers take another path in eval() mode)."""
    rng = np.random.default_rng(1)
    jm, params, tm = _head_pair(name)
    getattr(tm, mode)()
    c = rng.normal(size=(B, A)).astype(np.float32)
    for layout, q in _layouts(name, rng).items():
        want = jm(params, jnp.asarray(q))
        with torch.no_grad():
            got = tm(t(q))
        close(got, want, 1e-5, f"{name} {layout} {mode}")
        jg = jax.grad(lambda p: (jm(p, jnp.asarray(q)) * c).sum())(params)
        tm.zero_grad()
        (tm(t(q)) * t(c)).sum().backward()
        want_g = zoo_params_from_numpy(_np_tree(jg))
        for key, p in tm.named_parameters():
            # a parameter off the path (the deterministic Bayesian call's
            # fc1_logvar) has no torch gradient and a zero JAX one
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            close(g, want_g[key], 1e-4, f"{name} {layout} d{key}")


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", ["AttentionPortfolioOptimizer",
                                  "TransformerPortfolioOptimizer"])
def test_two_head_attention_matches_jax(name, mode):
    """K=4 with two heads: in eval() mode without grad, torch's attention
    may take its fused fast path, which must agree too."""
    rng = np.random.default_rng(2)
    jm, params, tm = _head_pair(name, k=4, n_heads=2)
    getattr(tm, mode)()
    q = _probs(rng, B, 9, 4).transpose(0, 2, 1).copy()
    with torch.no_grad():
        got = tm(t(q))
    close(got, jm(params, jnp.asarray(q)), 1e-5, f"{name} {mode}")


def test_attention_layers_match_jax_functions():
    """ops/attention.py's layers against the JAX functions they replace:
    mha, encoder_layer and transformer_encoder."""
    from vqvaehmm_tpu.ops import attention as ja
    from vqvaehmm_tpu_torch.ops import attention as ta

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 6, 4)).astype(np.float32)
    p = ja.init_mha(jax.random.PRNGKey(0), 4, 2)
    mha = ta.make_mha(4, 2)
    mha.load_state_dict(zoo_params_from_numpy(_np_tree(p), mha))
    with torch.no_grad():
        got = ta.self_attention(mha, t(x))
    close(got, ja.mha(p, jnp.asarray(x), 2), 1e-5)
    layers = ja.init_transformer_encoder(jax.random.PRNGKey(1), 4, 2, 16, 2)
    enc = ta.make_transformer_encoder(4, 2, 16, 2)
    enc.load_state_dict(zoo_params_from_numpy(_np_tree(layers), enc))
    out = t(x)
    with torch.no_grad():
        for layer in enc:
            out = layer(out)
    close(out, ja.transformer_encoder(layers, jnp.asarray(x), 2), 1e-5)


def test_port_init_draws_jax_distributions():
    """The port's initial draws follow JAX's: xavier-uniform in_proj,
    zero attention biases, LayerNorm ones, LSTM weights within
    1/sqrt(H), factor loadings N(0, 1), specific risks and temperature 1;
    a seed gives the same weights twice."""
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    head = tp.TransformerPortfolioOptimizer(tp.HeadConfig(4, A, H),
                                            n_heads=2, generator=g())
    sa = head.encoder[0].self_attn
    assert sa.in_proj_weight.abs().max() <= np.sqrt(6.0 / 8)
    assert not sa.in_proj_bias.any() and not sa.out_proj.bias.any()
    assert torch.equal(head.encoder[1].norm2.weight, torch.ones(4))
    again = tp.TransformerPortfolioOptimizer(tp.HeadConfig(4, A, H),
                                             n_heads=2, generator=g())
    for a, b in zip(head.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    lstm = tp.RegimeLSTMOptimizer(tp.HeadConfig(K, A, H), generator=g())
    assert lstm.lstm.weight_hh_l1.abs().max() <= 1 / np.sqrt(H)
    fm = tr.RegimeFactorModel(K, A, generator=g())
    assert fm.factor_loadings.shape == (K, A, 5)
    assert torch.equal(fm.specific_risk, torch.ones(K, A))
    assert torch.equal(tr.TemperatureScaling().temperature, torch.ones(1))


def test_ensemble_members_stacked():
    """The members' parameters stacked on a leading axis, as JAX's vmap
    layout: one batched product a layer, and each member is the MLP of
    its slice."""
    jm, params, tm = _head_pair("EnsemblePortfolioOptimizer", n_models=3)
    assert tm.fc1.weight.shape == (3, H, K) and tm.fc2.bias.shape == (3, A)
    q = t(_probs(np.random.default_rng(4), B, K))
    with torch.no_grad():
        members = [torch.softmax(torch.relu(q @ tm.fc1.weight[i].T
                                            + tm.fc1.bias[i])
                                 @ tm.fc2.weight[i].T + tm.fc2.bias[i], -1)
                   for i in range(3)]
        close(tm(q), torch.stack(members).mean(0), 1e-6)


def test_bayesian_on_jax_draws():
    """Sampled weights and their ddof=1 spread on JAX's own draws; a
    generator draws n_samples at once and repeats from a seed."""
    rng = np.random.default_rng(5)
    jm, params, tm = _head_pair("BayesianPortfolioOptimizer", n_samples=6)
    q = _probs(rng, B, K)
    key = jax.random.PRNGKey(9)
    w_j, u_j = jm(params, jnp.asarray(q), key=key, return_uncertainty=True)
    eps = jax.random.normal(key, (6, B, H), jnp.float32)
    with torch.no_grad():
        w_t, u_t = tm(t(q), eps=t(np.asarray(eps)), return_uncertainty=True)
        close(w_t, w_j, 1e-5, "weights")
        close(u_t, u_j, 1e-5, "uncertainty")
        close(tm(t(q), eps=t(np.asarray(eps))), jm(params, jnp.asarray(q),
                                                   key=key), 1e-5)
        a = tm(t(q), generator=torch.Generator().manual_seed(1))
        b = tm(t(q), generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and a.shape == (B, A)


def test_refusals_as_jax():
    cfg = tp.HeadConfig(K, A, H)
    for cls in (tp.AttentionPortfolioOptimizer,
                tp.TransformerPortfolioOptimizer):
        with pytest.raises(ValueError, match="not divisible by num_heads"):
            cls(cfg, n_heads=2)
    with pytest.raises(ValueError, match="not divisible by num_heads"):
        jp.AttentionPortfolioOptimizer(jp.HeadConfig(K, A, H), 2).init(
            jax.random.PRNGKey(0))
    q = t(_probs(np.random.default_rng(6), B, K))
    bay = tp.BayesianPortfolioOptimizer(cfg)
    with pytest.raises(ValueError, match="requires generator= or eps="):
        bay(q, return_uncertainty=True)
    one = tp.BayesianPortfolioOptimizer(cfg, n_samples=1)
    with pytest.raises(ValueError, match="n_samples >= 2"):
        one(q, generator=torch.Generator(), return_uncertainty=True)


REGIME_SEQ = [("RegimeChangeDetector", {}),
              ("ForwardTransitionPredictor", {"n_steps": 3})]


@pytest.mark.parametrize("name,kw", REGIME_SEQ)
def test_lstm_regime_models_match_jax(name, kw):
    """(B, T, K), (B, K, T) and the square (B, K, K), which passes through
    untransposed in both packages."""
    rng = np.random.default_rng(7)
    jm = getattr(jr, name)(K, hidden_dim=H, **kw)
    params = jm.init(jax.random.PRNGKey(2))
    tm = _carry(getattr(tr, name)(K, hidden_dim=H, **kw), params)
    q_tk = _probs(rng, B, T, K)
    sq = _probs(rng, B, K, K)
    for q in (q_tk, q_tk.transpose(0, 2, 1).copy(), sq):
        with torch.no_grad():
            close(tm(t(q)), jm(params, jnp.asarray(q)), 1e-5, name)
    with torch.no_grad():
        assert not torch.allclose(tm(t(sq)), tm(t(sq.transpose(0, 2, 1)
                                                    .copy())))


def test_persistence_and_factor_models_match_jax():
    rng = np.random.default_rng(8)
    jm = jr.RegimePersistenceModel(K, hidden_dim=H)
    params = jm.init(jax.random.PRNGKey(4))
    tm = _carry(tr.RegimePersistenceModel(K, hidden_dim=H), params)
    A_mat = rng.dirichlet(np.ones(K), size=K).astype(np.float32)
    for q in (_probs(rng, B, K),
              _probs(rng, B, T, K).transpose(0, 2, 1).copy()):
        for a in (A_mat, np.stack([A_mat] * B)):
            with torch.no_grad():
                close(tm(t(q), t(a)), jm(params, jnp.asarray(q),
                                         jnp.asarray(a)), 1e-5)
    jf = jr.RegimeFactorModel(K, A, n_factors=2)
    fp = jf.init(jax.random.PRNGKey(5))
    tf = _carry(tr.RegimeFactorModel(K, A, n_factors=2), fp)
    for q in (_probs(rng, B, K),
              _probs(rng, B, T, K).transpose(0, 2, 1).copy()):
        with torch.no_grad():
            close(tf.get_covariance(t(q)),
                  jf.get_covariance(fp, jnp.asarray(q)), 1e-5)


@pytest.mark.parametrize("start", [1.0, 0.3])
def test_temperature_calibrate_matches_jax(start):
    """max_iter steps of Adam on the log-temperature from the same start
    reach JAX's temperature within 1e-4 relative, and the calibrated
    scaling equals JAX's."""
    rng = np.random.default_rng(9)
    labels = rng.integers(0, K, size=64)
    logits = (rng.normal(size=(64, K)) + 3.0 * np.eye(K)[labels]) \
        .astype(np.float32) * 0.5
    jts = jr.TemperatureScaling()
    jparams, jt = jts.calibrate({"temperature": jnp.full((1,), start)},
                                logits, labels, max_iter=150)
    ts = tr.TemperatureScaling()
    with torch.no_grad():
        ts.temperature.fill_(start)
    params, got = ts.calibrate(logits, labels, max_iter=150)
    assert abs(got - jt) <= 1e-4 * jt
    assert torch.equal(params["temperature"], ts.temperature.detach())
    with torch.no_grad():
        close(ts(t(logits)), jts(jparams, jnp.asarray(logits)), 1e-4)


def test_regime_utilities_match_jax():
    rng = np.random.default_rng(10)
    q_kt = _probs(rng, B, T, K).transpose(0, 2, 1).copy()
    rets = rng.normal(0, 0.02, size=(B, T, A)).astype(np.float32)
    w = _probs(rng, B, A)
    labels = rng.integers(0, K, size=(B, T))
    assert tr.calibrate_probabilities(t(q_kt.transpose(0, 2, 1)), labels) \
        == jr.calibrate_probabilities(q_kt.transpose(0, 2, 1), labels)
    for q in (q_kt, q_kt.transpose(0, 2, 1).copy()):     # the layout sniff
        close(tr.estimate_regime_covariance(t(rets), t(q), K),
              jr.estimate_regime_covariance(jnp.asarray(rets),
                                            jnp.asarray(q), K), 1e-6)
    zero = np.zeros_like(q_kt)
    zero[:, 0] = 1.0                       # regimes 1 and 2 never weighted
    got = tr.estimate_regime_covariance(t(rets), t(zero), K)
    assert torch.isfinite(got).all()
    close(got, jr.estimate_regime_covariance(jnp.asarray(rets),
                                             jnp.asarray(zero), K), 1e-6)
    for q in (q_kt, q_kt[:, :, -1].copy()):
        close(tr.confidence_based_sizing(t(w), t(q)),
              jr.confidence_based_sizing(jnp.asarray(w), jnp.asarray(q)),
              1e-6)
    for scale in (1.0, 1e-4, 100.0):
        got = tr.optimize_rebalancing_frequency(t(q_kt), None,
                                                t(rets * scale))
        want = jr.optimize_rebalancing_frequency(q_kt, None,
                                                 jnp.asarray(rets * scale))
        assert got.dtype == torch.int32 and int(got) == int(want)
    close(tr.optimize_leverage(t(w), t(rets)),
          jr.optimize_leverage(jnp.asarray(w), jnp.asarray(rets)), 1e-5)


def test_gradio_demo_builds_a_transformer_head(tmp_path):
    """With no head checkpoint the demo's head is a seeded
    TransformerPortfolioOptimizer, as JAX's; the allocation is its
    weights on the served posterior."""
    from tests.torch_port import write_serving_config
    from vqvaehmm_tpu_torch.serve.app import get_model
    from vqvaehmm_tpu_torch.serve.gradio_app import (make_infer_fn,
                                                     parse_market_text)

    cfg_path = write_serving_config(tmp_path)
    get_model.cache_clear()
    try:
        infer = make_infer_fn(cfg_path, device="cpu")
        text = "\n".join(" ".join(f"{0.1 * (i - j % 4):.3f}"
                                  for j in range(10)) for i in range(5))
        _, _, alloc = infer(text)
        m = get_model(cfg_path, "cpu")
        cfg = m.cfg
        head = tp.TransformerPortfolioOptimizer(
            tp.HeadConfig(cfg.model.K, cfg.portfolio.n_assets,
                          cfg.portfolio.hidden_dim),
            generator=torch.Generator().manual_seed(0)).eval()
        with torch.inference_mode():
            q = m.model.posterior(torch.from_numpy(parse_market_text(text)))
            w = head(q)[0].numpy()
        assert list(alloc.values()) == [f"{v * 100:.2f}%" for v in w]
    finally:
        get_model.cache_clear()


def test_zoo_imports_no_jax():
    """The new modules import torch and numpy only."""
    import subprocess
    import sys

    code = ("import sys; import vqvaehmm_tpu_torch.models, "
            "vqvaehmm_tpu_torch.models.regime, "
            "vqvaehmm_tpu_torch.ops.attention, "
            "vqvaehmm_tpu_torch.train.strategies, "
            "vqvaehmm_tpu_torch.calibration, vqvaehmm_tpu_torch.recipe; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'vqvaehmm_tpu.')) or m == 'vqvaehmm_tpu']; "
            "print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
