"""The bfloat16 model's plain path (compute_dtype "bfloat16") on the CPU
against the JAX package's XLA path in bfloat16, and serving such a model.

The port rounds where XLA does: each product (a convolution, a linear
layer, the codebook lookup) rounded to bfloat16, its bias added in
bfloat16 and rounded again, the ReLUs and masks in bfloat16; logits,
(mu, logvar) and the transition logits back to float32.  Measured at
these widths: the forward bit-equal or within 1.6e-6 (posteriors), the
loss within 3.2e-6 relative, every weight gradient bit-equal to JAX's.
The stated tolerances (1e-5 absolute on probabilities and the serving
outputs, 1e-5 relative on the loss, 1e-4 of a leaf's largest entry on a
weight gradient) are a few times those gaps and below the gap between
the bfloat16 and the float32 model (measured 5.6e-4 to 2.5e-3 on the
outputs, 4.5e-4 on the loss, 2.5e-3 to 0.23 on the gradients).

A bias gradient is the one place the two differ by design: XLA on the
CPU sums a bfloat16 bias gradient sequentially in bfloat16, row-major
over (B, T), where the port sums in float32 and rounds once (measured
up to 2.1e-2 of the leaf's largest entry apart, the same size as the
bfloat16-float32 gap).  So the port's bias cotangents, summed as XLA
sums them, are held to JAX's bias gradients (measured bit-equal)."""

import json
import socket
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port import SMALL, inputs, model_pair, t
from vqvaehmm_tpu import make_model
from vqvaehmm_tpu_torch.data.checkpoint import params_from_numpy
from vqvaehmm_tpu_torch.ops import fused_decode, fused_encoder, fused_infer
from vqvaehmm_tpu_torch.ops import nn as ops
from vqvaehmm_tpu_torch.ops.fused_infer import kernel_route

BF16 = dict(compute_dtype="bfloat16", matmul_precision="default")
# the order compute_loss reaches the layers with a bias: prior, encoder,
# decoder
BIASES = ("prior.transition_net.0", "prior.transition_net.2",
          "encoder.conv1", "encoder.conv2", "encoder.to_logits",
          "decoder.conv1", "decoder.conv2", "decoder.to_params")


def _state(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _gap(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _xla_bias_sum(g: torch.Tensor, channels_at: int) -> torch.Tensor:
    """A bfloat16 cotangent summed over every axis but `channels_at`,
    sequentially in bfloat16 in row-major order (XLA on the CPU)."""
    rows = g.movedim(channels_at, -1).reshape(-1, g.shape[channels_at])
    acc = torch.zeros(rows.shape[1], dtype=torch.bfloat16)
    for row in rows:
        acc = acc + row
    return acc.float()


def test_plain_bf16_path_matches_jax_xla_bf16(monkeypatch):
    """(c) loss, jax.grad, posterior, infer_forward, smoothed, filtered
    and viterbi of the bfloat16 model against JAX's; log_pi bit-equal to
    the float32 model's; parameters float32."""
    jm, params, tm = model_pair(seed=1, **BF16)
    jm32, params32, tm32 = model_pair(seed=1)
    x, u, lengths = inputs(4, 32, seed=2)
    jargs = (jnp.asarray(x), jnp.asarray(u), jnp.asarray(lengths))
    targs = (t(x), t(u), t(lengths))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert torch.equal(tm.prior(t(u))[0], tm32.prior(t(u))[0])

    # the loss and its gradient, with the cotangent of each product (that
    # of its bias too) captured in the order the forward calls them
    calls, cotangents = [], {}
    for name, at in (("conv1d_same", 1), ("linear", -1)):
        def record(*args, fn=getattr(ops, name), at=at):
            idx = len(calls)
            calls.append(at)
            y = fn(*args)
            y.register_hook(lambda g: cotangents.__setitem__(idx, g))
            return y
        monkeypatch.setattr(ops, name, record)
    names, leaves = zip(*tm.named_parameters())
    loss = tm.compute_loss(*targs, 1.0)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    monkeypatch.undo()
    jl, jg = jax.value_and_grad(jm.compute_loss)(params, *jargs, 1.0)
    jl32, jg32 = jax.value_and_grad(jm32.compute_loss)(params32, *jargs, 1.0)
    jg, jg32 = _state(jg), _state(jg32)
    loss = loss.detach()
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    assert abs(float(jl32) - float(jl)) > 1e-5 * abs(float(jl))
    worst32 = 0.0
    for name, w in jg.items():
        scale = float(w.abs().max())
        worst32 = max(worst32, _gap(jg32[name], w) / scale)
        if not name.endswith("bias"):
            assert _gap(grads[name], w) <= 1e-4 * scale, name
    assert worst32 > 1e-2
    assert len(calls) == len(cotangents) == len(BIASES)
    for i, (name, at) in enumerate(zip(BIASES, calls)):
        g = cotangents[i]
        want = jg[name + ".bias"]
        assert _gap(_xla_bias_sum(g, at), want) \
            <= 1e-6 * float(want.abs().max()), name

    # the serving and exact-inference outputs
    with torch.no_grad():
        got = {"posterior": tm.posterior(t(x)),
               "smoothed": tm.smoothed_posterior(*targs),
               "filtered": tm.filtered_posterior(*targs)}
        got.update(zip(("mu", "logvar", "q"),
                       tm.infer_forward(t(x), valid_to=t(lengths))))
        states = tm.viterbi_decode(*targs)
    for jmod, jpar, tol_side in ((jm, params, "bf16"),
                                 (jm32, params32, "f32")):
        want = {"posterior": jmod.posterior(jpar, jargs[0]),
                "smoothed": jmod.smoothed_posterior(jpar, *jargs),
                "filtered": jmod.filtered_posterior(jpar, *jargs)}
        want.update(zip(("mu", "logvar", "q"), jmod.infer_forward(
            jpar, jargs[0], valid_to=jargs[2])))
        for key, w in want.items():
            if tol_side == "bf16":
                assert _gap(got[key], w) <= 1e-5, key
            else:
                assert _gap(got[key], w) > 1e-5, key
    np.testing.assert_array_equal(
        states.numpy(), np.asarray(jm.viterbi_decode(params, *jargs)))


def test_kernel_route_of_a_bf16_model():
    """(j) use_kernel=None takes the float32 kernels for a CUDA tensor of a
    float32 model only; use_kernel=True on a bfloat16 model raises."""
    on_card = SimpleNamespace(is_cuda=True)
    f32 = SimpleNamespace(cfg=SimpleNamespace(compute_dtype="float32"))
    bf16 = SimpleNamespace(cfg=SimpleNamespace(compute_dtype="bfloat16"))
    assert kernel_route(f32, on_card, None)
    assert not kernel_route(bf16, on_card, None)
    assert not kernel_route(f32, SimpleNamespace(is_cuda=False), None)
    assert kernel_route(bf16, on_card, True)
    assert not kernel_route(f32, on_card, False)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A bfloat16 serving config on a JAX-written checkpoint and head, the
    port's HTTP server on the CPU, and JAX's InferenceModel on the same
    files."""
    from vqvaehmm_tpu.data.checkpoint import save_params_npz
    from vqvaehmm_tpu.models.portfolio import (HeadConfig,
                                               RegimePortfolioOptimizer)
    from vqvaehmm_tpu.serve.app import InferenceModel as JaxModel
    from vqvaehmm_tpu_torch.serve.httpd import serve

    tmp = tmp_path_factory.mktemp("torch_bf16_serve")
    save_params_npz(str(tmp / "model.npz"),
                    make_model(**SMALL).init(jax.random.PRNGKey(3)))
    head = RegimePortfolioOptimizer(HeadConfig(K=3, n_assets=4,
                                               hidden_dim=6))
    save_params_npz(str(tmp / "head.npz"), head.init(jax.random.PRNGKey(4)))
    cfg = {"model": {**SMALL, **BF16},
           "portfolio": {"n_assets": 4, "hidden_dim": 6},
           "checkpoint_path": str(tmp / "model.npz"),
           "head_checkpoint_path": str(tmp / "head.npz")}
    cfg_path = tmp / "inference_config.json"
    cfg_path.write_text(json.dumps(cfg))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(str(cfg_path), host="127.0.0.1", port=port,
                  background=True, device="cpu")
    yield f"http://127.0.0.1:{port}", JaxModel(str(cfg_path)), httpd
    httpd.shutdown()
    httpd.server_close()


def _request(T, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(5, T)).tolist(),
            "u": rng.normal(size=(4, T)).tolist()}


def test_bf16_config_served_in_four_modes_and_predict(served):
    """(g) /infer in the four modes and /predict of a bfloat16 config over
    HTTP against JAX: within 1e-5 of JAX's eager bfloat16 path on the
    server's padded request (the rounding points of test (c)), states
    equal; within 4e-3 of JAX's InferenceModel, whose jitted graph XLA
    fuses and so rounds to bfloat16 in fewer places (measured 1.5e-3, as
    far as JAX's own float32 server is from it: one bfloat16 rounding of
    these magnitudes is up to 3.9e-3)."""
    from tests.torch_port import post_json
    from vqvaehmm_tpu_torch.serve.app import DEFAULT_BUCKETS

    url, jax_model, httpd = served
    assert httpd.vqhmm_model.model.compute_dtype == torch.bfloat16
    jm = make_model(**SMALL, **BF16)
    params = jax_model.params
    for T, seed in ((37, 1),):
        req = _request(T, seed)
        pad = next(b for b in DEFAULT_BUCKETS if b >= T)
        xp, up = (jnp.pad(jnp.asarray(req[k], jnp.float32),
                          ((0, 0), (0, pad - T)))[None] for k in "xu")
        lens = jnp.asarray([T], jnp.int32)
        mu, logvar, q = (a[0, :, :T] for a in jm.infer_forward(
            params, xp, valid_to=T))
        eager = {"mu": mu, "logvar": logvar, "mean_field": q,
                 "smoothed": jm.smoothed_posterior(params, xp, up,
                                                   lens)[0, :, :T],
                 "filtered": jm.filtered_posterior(params, xp, up,
                                                   lens)[0, :, :T],
                 "viterbi": q}
        for mode in ("mean_field", "smoothed", "filtered", "viterbi"):
            payload = dict(req, mode=mode) if mode != "mean_field" \
                else {"x": req["x"]}
            status, got, _ = post_json(url + "/infer", payload)
            want = jax_model.infer(req["x"], u=req["u"], mode=mode)
            assert status == 200 and set(got) == set(want)
            for key in ("mu", "logvar", "regime_probs"):
                assert _gap(got[key], want[key]) <= 4e-3, (mode, key)
                ref = eager[mode if key == "regime_probs" else key]
                assert _gap(got[key], ref) <= 1e-5, (mode, key)
            if mode == "viterbi":
                assert got["states"] == want["states"]
    x = _request(25, 3)["x"]
    status, got, _ = post_json(url + "/predict", {"x": x})
    want = jax_model.predict(x)
    assert status == 200
    for key in ("weights", "regime_probs"):
        assert _gap(got[key], want[key]) <= 4e-3, key


def test_bf16_serving_launches_no_float32_kernel(served, monkeypatch):
    """(j) With every tensor taken for a CUDA one where the route is
    chosen, a bfloat16 model's /infer (four modes), /predict and /stream
    reach no launch of kernels A, 8 or 11 (each launcher here counts and
    raises); a float32 model's mean-field request does reach kernel A's
    route.  A micro-batched bfloat16 row equals its solo row within 1e-5
    (the bit-identity of a batched row belongs to kernel A)."""
    import concurrent.futures

    from vqvaehmm_tpu_torch.serve.batching import BatchingModel

    _, _, httpd = served
    model = httpd.vqhmm_model
    launched = []

    def launcher(name):
        def launch(*args, **kw):
            launched.append(name)
            raise AssertionError(f"kernel {name} launched")
        return launch

    for mod, attr, name in ((fused_infer, "_launch", "A"),
                            (fused_encoder, "_launch", "8"),
                            (fused_decode, "_launch_evidence", "11")):
        monkeypatch.setattr(mod, attr, launcher(name))
    def on_card(m, x, use):
        return kernel_route(m, SimpleNamespace(is_cuda=True), use)

    for mod in (fused_infer, fused_encoder, fused_decode):
        monkeypatch.setattr(mod, "kernel_route", on_card)
    before = (fused_infer.fused_forward.launches,
              fused_encoder.fused_encode.launches,
              fused_decode.fused_evidence.launches)
    req = _request(40, 7)
    for mode in ("mean_field", "smoothed", "filtered", "viterbi"):
        model.infer(req["x"], u=req["u"], mode=mode)
    model.predict(req["x"])
    for i in range(4):
        model.stream("s", x_t=[float(v[i]) for v in req["x"]],
                     u_t=[float(v[i]) for v in req["u"]])
    with torch.no_grad():
        model.model.posterior(t(np.asarray(req["x"], np.float32)[None]))
    assert launched == [] and before == (
        fused_infer.fused_forward.launches,
        fused_encoder.fused_encode.launches,
        fused_decode.fused_evidence.launches)
    _, _, tm32 = model_pair(seed=3)
    # outside autograd, as a server calls it: under it the default
    # dispatch takes the differentiable plain path
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        tm32.infer_forward(t(np.asarray(req["x"], np.float32)[None]))
    monkeypatch.undo()

    b = BatchingModel(model, max_batch=4, max_wait_ms=5000.0)
    try:
        rng = np.random.default_rng(0)
        xs = [rng.normal(size=(5, T)).tolist() for T in (17, 23, 29, 31)]
        solo = [model.infer(x) for x in xs]
        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            batched = list(ex.map(b.infer, xs))
        assert b.dispatches == 1
        for s, r in zip(solo, batched):
            for key in ("mu", "logvar", "regime_probs"):
                assert _gap(s[key], r[key]) <= 1e-5, key
    finally:
        b.close()


def test_use_kernel_true_on_a_bf16_model_raises():
    """use_kernel=True on a bfloat16 model raises before anything else:
    kernel A computes in float32 (the other kernels' gates refuse
    bfloat16 too, tests/test_torch_fused_encoder.py and
    tests/test_torch_fused_decode.py)."""
    _, _, tm = model_pair(seed=4, **BF16)
    with pytest.raises(ValueError, match="float32"):
        tm.infer_forward(torch.zeros(1, 5, 8), use_kernel=True)
