"""The port's VQ serving surface (vqvaehmm_tpu_torch/serve/vq.py) behind
its HTTP server on the CPU, with the committed archive
artifacts/checkpoints_vq/vq_stack.npz: the contract of
tests/test_vq_pipeline.py::test_vq_serving_http, and every answer held
against the JAX package's VQInferenceModel on the same files (codes and
states equal, probabilities and weights <= 1e-4: float32, other
summation orders)."""

import json
import os
import socket
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import tests.torch_port  # noqa: F401  (one torch thread per worker)
from vqvaehmm_tpu_torch.ops.fused_viterbi import viterbi_fused
from vqvaehmm_tpu_torch.ops.vq import vq_nearest
from vqvaehmm_tpu_torch.serve.vq import VQInferenceModel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHIVE = os.path.join(ROOT, "artifacts", "checkpoints_vq", "vq_stack.npz")


def _config(tmp, **over):
    with open(os.path.join(ROOT, "artifacts", "config_vq.json")) as f:
        cfg = json.load(f)
    cfg["checkpoint_path"] = ARCHIVE
    cfg["portfolio"] = {"n_assets": 4, "hidden_dim": 6}
    cfg["head_checkpoint_path"] = str(tmp / "head.npz")
    for key, value in over.items():
        section, _, leaf = key.partition("__")
        if leaf:
            cfg[section][leaf] = value
        else:
            cfg[section] = value
    path = tmp / f"inference_{len(os.listdir(tmp))}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from vqvaehmm_tpu.data.checkpoint import save_params_npz
    from vqvaehmm_tpu.models.portfolio import (HeadConfig,
                                               RegimePortfolioOptimizer)
    from vqvaehmm_tpu.serve.vq import VQInferenceModel as JaxModel
    from vqvaehmm_tpu_torch.serve.httpd import serve

    tmp = tmp_path_factory.mktemp("torch_vq_serve")
    head = RegimePortfolioOptimizer(HeadConfig(K=3, n_assets=4,
                                               hidden_dim=6))
    save_params_npz(str(tmp / "head.npz"), head.init(jax.random.PRNGKey(4)))
    cfg_path = _config(tmp)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    httpd = serve(cfg_path, host="127.0.0.1", port=port, background=True,
                  device="cpu")
    yield f"http://127.0.0.1:{port}", JaxModel(cfg_path), httpd, tmp
    httpd.shutdown()
    httpd.server_close()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _code(url, payload):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(url, payload)
    return e.value.code


def _x(T, seed):
    return np.random.default_rng(seed).normal(size=(5, T)).tolist()


@pytest.mark.parametrize("mode", [None, "smoothed", "filtered", "viterbi",
                                  "mean_field"])
def test_infer_modes_match_jax(setup, mode):
    url, jax_model, httpd, _ = setup
    # the server holds get_model's handle, around the family's model
    assert isinstance(httpd.vqhmm_model._inner, VQInferenceModel)
    assert httpd.vqhmm_model.checkpoint_loaded
    launches = (vq_nearest.launches, viterbi_fused.launches)
    # two buckets of the ladder, and a T past its top (padded to itself)
    for T, seed in ((37, 1), (70, 2), (530, 3)):
        x = _x(T, seed)
        payload = {"x": x} if mode is None else {"x": x, "mode": mode}
        status, got = _post(url + "/infer", payload)
        want = jax_model.infer(x, mode=mode or "mean_field")
        assert status == 200 and set(got) == set(want)
        assert got["mode"] == want["mode"] == (
            mode if mode in ("filtered", "viterbi") else "smoothed")
        assert got["codes"] == want["codes"] and len(got["codes"]) == T
        if mode == "viterbi":
            assert got["states"] == want["states"]
        else:
            q = np.array(got["regime_probs"])
            assert q.shape == (3, T)
            np.testing.assert_allclose(q.sum(0), 1.0, rtol=0, atol=1e-4)
            np.testing.assert_allclose(q, np.array(want["regime_probs"]),
                                       rtol=0, atol=1e-4)
    # on the CPU no kernel launches
    assert (vq_nearest.launches, viterbi_fused.launches) == launches


def test_predict_matches_jax(setup):
    url, jax_model, _, _ = setup
    x = _x(25, 4)
    status, got = _post(url + "/predict", {"x": x})
    want = jax_model.predict(x)
    assert status == 200 and set(got) == {"weights", "regime_probs"}
    for key in got:
        np.testing.assert_allclose(np.array(got[key]), np.array(want[key]),
                                   atol=1e-4, rtol=0, err_msg=key)
    np.testing.assert_allclose(sum(got["weights"]), 1.0, atol=1e-5)


def test_error_contract_and_metrics(setup):
    url, _, httpd, _ = setup
    x = _x(20, 5)
    assert _code(url + "/infer", {"x": [[0.0] * 10] * 3}) == 400  # wrong C
    assert _code(url + "/infer", {"y": []}) == 400
    assert _code(url + "/infer", {"x": x, "mode": "bogus"}) == 400
    nan_x = [row[:] for row in x]
    nan_x[0][3] = float("nan")
    assert _code(url + "/infer", {"x": nan_x}) == 400
    assert _code(url + "/predict", {"x": [[1.0]]}) == 400
    # u is accepted and ignored
    assert _post(url + "/infer", {"x": x, "u": [[0.0] * 20] * 4})[0] == 200
    # streaming is for the VAE family: the model refuses as a client error
    with pytest.raises(ValueError, match="family=vae"):
        httpd.vqhmm_model.stream("s", [0.0] * 5, [0.0] * 4)
    with urllib.request.urlopen(url + "/health", timeout=60) as resp:
        assert json.loads(resp.read()) == {"status": "ok"}
    with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
        text = resp.read().decode()
    assert "vqhmm_checkpoint_loaded 1" in text
    assert "vqhmm_kernel_launches_vq_nearest" in text
    assert "vqhmm_kernel_launches_viterbi" in text


def test_missing_archive_and_mismatches(setup, monkeypatch):
    from vqvaehmm_tpu_torch.serve.app import InferenceModel, get_model

    _, _, _, tmp = setup
    missing = _config(tmp, checkpoint_path=str(tmp / "missing_archive"))
    monkeypatch.setenv("VQHMM_REQUIRE_CHECKPOINT", "1")
    with pytest.raises(FileNotFoundError):
        VQInferenceModel(missing, device="cpu")
    monkeypatch.setenv("VQHMM_REQUIRE_CHECKPOINT", "0")
    demo = get_model(missing, "cpu")              # dispatches on the family
    assert isinstance(demo._inner, VQInferenceModel)
    assert not demo.checkpoint_loaded
    out = demo.infer(_x(12, 6))
    assert len(out["codes"]) == 12
    np.testing.assert_allclose(np.array(out["regime_probs"]), 1.0 / 3,
                               atol=1e-6)         # the uniform demo HMM
    for over, what in ((dict(vq__num_codes=12), "num_codes"),
                       (dict(vq__latent_dim=4), "latent_dim"),
                       (dict(model__K=4), "K=3"),
                       (dict(model__input_dim=7), "input_dim")):
        with pytest.raises(ValueError, match=what):
            VQInferenceModel(_config(tmp, **over), device="cpu")
    with pytest.raises(ValueError, match="get_model"):
        InferenceModel(missing, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            VQInferenceModel(missing)
