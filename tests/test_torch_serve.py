"""The port's HTTP server (vqvaehmm_tpu_torch.serve.httpd) on the CPU,
held against the JAX package's InferenceModel on the same files: every
/infer mode and /predict to <= 1e-4, and the 400 contract of
tests/test_serve.py."""

import json
import os
import socket
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

import tests.torch_port  # noqa: F401  (one torch thread per worker)
from tests.torch_port import SMALL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from vqvaehmm_tpu import make_model
    from vqvaehmm_tpu.data.checkpoint import save_params_npz
    from vqvaehmm_tpu.models.portfolio import (HeadConfig,
                                               RegimePortfolioOptimizer)
    from vqvaehmm_tpu.serve.app import InferenceModel as JaxModel
    from vqvaehmm_tpu_torch.serve.httpd import serve

    tmp = tmp_path_factory.mktemp("torch_serve")
    params = make_model(**SMALL).init(jax.random.PRNGKey(3))
    save_params_npz(str(tmp / "model.npz"), params)
    head = RegimePortfolioOptimizer(HeadConfig(K=3, n_assets=4,
                                               hidden_dim=6))
    save_params_npz(str(tmp / "head.npz"), head.init(jax.random.PRNGKey(4)))
    cfg = {"model": SMALL, "portfolio": {"n_assets": 4, "hidden_dim": 6},
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


def _request(T, seed):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(5, T)).tolist(),
            "u": rng.normal(size=(4, T)).tolist()}


@pytest.mark.parametrize("mode", ["mean_field", "smoothed", "filtered",
                                  "viterbi"])
def test_infer_modes_match_jax(setup, mode):
    url, jax_model, httpd = setup
    assert httpd.vqhmm_model.checkpoint_loaded
    # two buckets of the ladder, and a T past its top (padded to itself)
    for T, seed in ((37, 1), (70, 2), (530, 3)):
        req = _request(T, seed)
        payload = dict(req, mode=mode) if mode != "mean_field" \
            else {"x": req["x"]}
        status, got = _post(url + "/infer", payload)
        want = jax_model.infer(req["x"], u=req["u"], mode=mode)
        assert status == 200
        assert set(got) == set(want)
        for key in ("mu", "logvar", "regime_probs"):
            np.testing.assert_allclose(np.array(got[key]),
                                       np.array(want[key]), atol=1e-4,
                                       rtol=0, err_msg=f"{mode} {key}")
        if mode == "viterbi":
            assert got["states"] == want["states"]
            assert got["mode"] == "viterbi"


def test_predict_matches_jax(setup):
    url, jax_model, _ = setup
    x = _request(25, 3)["x"]
    status, got = _post(url + "/predict", {"x": x})
    want = jax_model.predict(x)
    assert status == 200 and set(got) == {"weights", "regime_probs"}
    for key in got:
        np.testing.assert_allclose(np.array(got[key]), np.array(want[key]),
                                   atol=1e-4, rtol=0, err_msg=key)
    np.testing.assert_allclose(sum(got["weights"]), 1.0, atol=1e-5)


def test_concurrent_requests_agree(setup):
    """Threads hammering /infer all succeed and agree with a serial
    answer (the handler threads share one model)."""
    import concurrent.futures

    url, _, _ = setup
    req = _request(45, 8)
    payload = dict(req, mode="viterbi")
    _, serial = _post(url + "/infer", payload)
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        results = list(ex.map(lambda _: _post(url + "/infer", payload),
                              range(16)))
    for status, out in results:
        assert status == 200
        assert out == serial


def test_error_contract(setup):
    url, _, _ = setup
    req = _request(20, 4)
    assert _code(url + "/infer", {"x": [[1.0, 2.0]]}) == 400     # wrong C
    assert _code(url + "/infer", {"y": []}) == 400               # no x
    assert _code(url + "/infer", [1, 2]) == 400                  # not an object
    assert _code(url + "/infer", {"x": {"a": 1}}) == 400         # malformed
    nan_x = [row[:] for row in req["x"]]
    nan_x[0][3] = float("nan")
    assert _code(url + "/infer", {"x": nan_x}) == 400            # non-finite
    assert _code(url + "/infer", {"x": [[1e39] * 20] * 5}) == 400  # f32 inf
    assert _code(url + "/infer", {"x": req["x"],
                                  "mode": "smoothed"}) == 400    # no u
    assert _code(url + "/infer", {"x": req["x"], "u": req["u"][:2],
                                  "mode": "viterbi"}) == 400     # wrong U
    assert _code(url + "/infer", {"x": req["x"], "u": req["u"],
                                  "mode": "bogus"}) == 400
    assert _code(url + "/predict", {"x": [[1.0]]}) == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=60)
    assert e.value.code == 404


def test_health_and_metrics(setup):
    url, _, _ = setup
    with urllib.request.urlopen(url + "/health", timeout=60) as resp:
        assert json.loads(resp.read()) == {"status": "ok"}
    _post(url + "/infer", {"x": _request(10, 5)["x"]})
    with urllib.request.urlopen(url + "/metrics", timeout=60) as resp:
        text = resp.read().decode()
    assert 'vqhmm_requests_total{endpoint="/infer",status="200"}' in text
    assert "vqhmm_checkpoint_loaded 1" in text


def test_missing_checkpoint_and_device(tmp_path, monkeypatch):
    from vqvaehmm_tpu_torch.serve.app import InferenceModel

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"model": SMALL, "checkpoint_path":
                                    str(tmp_path / "nonexistent")}))
    monkeypatch.setenv("VQHMM_REQUIRE_CHECKPOINT", "1")
    with pytest.raises(FileNotFoundError):
        InferenceModel(str(cfg_path), device="cpu")
    monkeypatch.setenv("VQHMM_REQUIRE_CHECKPOINT", "0")
    m = InferenceModel(str(cfg_path), device="cpu")
    assert not m.checkpoint_loaded
    assert len(m.infer(_request(12, 6)["x"])["mu"][0]) == 12
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            InferenceModel(str(cfg_path), device="cuda")


def test_server_import_needs_no_jax():
    code = ("import sys, vqvaehmm_tpu_torch.serve.httpd, "
            "vqvaehmm_tpu_torch.serve.asgi, vqvaehmm_tpu_torch.serve.cli, "
            "vqvaehmm_tpu_torch.serve.gradio_app, "
            "vqvaehmm_tpu_torch.models.online, "
            "vqvaehmm_tpu_torch.ops.fused_infer, "
            "vqvaehmm_tpu_torch.ops.fused_viterbi, "
            "vqvaehmm_tpu_torch.models.gmm, "
            "vqvaehmm_tpu_torch.train.gmm_pipeline; "
            "bad = [m for m in ('jax', 'triton', 'vqvaehmm_tpu', 'pandas', "
            "'sklearn') if m in sys.modules]; print(bad); "
            "sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
