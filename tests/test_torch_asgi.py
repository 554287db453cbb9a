"""The port's ASGI app (vqvaehmm_tpu_torch.serve.asgi), its FastAPI app
(serve/app.py::create_app) and its Gradio callback on the CPU, case by
case after tests/test_asgi.py, driven by hand-built ASGI scopes and the
in-repo fastapi and gradio doubles (tests/fastapi_stub.py,
tests/gradio_stub.py); the test of the real fastapi skips without it."""

import asyncio
import json
import sys

import numpy as np
import pytest

import tests.torch_port  # noqa: F401  (one torch thread per worker)
from tests.torch_port import write_serving_config


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    import jax

    from vqvaehmm_tpu.data.checkpoint import save_params_npz
    from vqvaehmm_tpu.models.portfolio import (HeadConfig,
                                               RegimePortfolioOptimizer)

    tmp = tmp_path_factory.mktemp("torch_asgi")
    head = RegimePortfolioOptimizer(HeadConfig(K=3, n_assets=10,
                                               hidden_dim=6))
    save_params_npz(str(tmp / "head.npz"), head.init(jax.random.PRNGKey(4)))
    return write_serving_config(
        tmp, seed=4, portfolio={"n_assets": 10, "hidden_dim": 6},
        head_checkpoint_path=str(tmp / "head.npz"))


@pytest.fixture
def app(cfg_path):
    from vqvaehmm_tpu_torch.serve.app import get_model
    from vqvaehmm_tpu_torch.serve.asgi import create_asgi_app

    yield create_asgi_app(cfg_path, device="cpu")
    get_model.cache_clear()


def asgi_request(app, method, path, payload=None, body=None):
    """(status, JSON body, headers) of one request through the ASGI
    protocol, in process."""
    if body is None:
        body = json.dumps(payload).encode() if payload is not None else b""
    scope = {"type": "http", "method": method, "path": path, "headers": []}
    sent = []

    async def receive():
        return {"type": "http.request", "body": body, "more_body": False}

    async def send(msg):
        sent.append(msg)

    asyncio.run(app(scope, receive, send))
    start = next(m for m in sent if m["type"] == "http.response.start")
    data = b"".join(m.get("body", b"") for m in sent
                    if m["type"] == "http.response.body")
    return start["status"], json.loads(data), dict(start["headers"])


def test_asgi_contract_matches_jax(app, cfg_path):
    """Every route and mode; the answers held against the JAX package's
    InferenceModel on the same checkpoint (mean-field and /predict within
    1e-5 on q and weights, 1e-4 elsewhere; Viterbi states equal)."""
    from vqvaehmm_tpu.serve.app import InferenceModel as JaxModel

    jm = JaxModel(cfg_path)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 24)).tolist()
    u = rng.normal(size=(4, 24)).tolist()
    assert asgi_request(app, "GET", "/health")[:2] == (200,
                                                       {"status": "ok"})
    for mode in ("mean_field", "smoothed", "filtered", "viterbi"):
        st, out, _ = asgi_request(app, "POST", "/infer",
                                  {"x": x, "u": u, "mode": mode})
        want = jm.infer(x, u=u, mode=mode)
        assert st == 200 and set(out) == set(want)
        for key in ("mu", "logvar", "regime_probs"):
            tol = 1e-5 if key == "regime_probs" and mode == "mean_field" \
                else 1e-4
            np.testing.assert_allclose(np.array(out[key]),
                                       np.array(want[key]), rtol=0,
                                       atol=tol, err_msg=f"{mode} {key}")
        if mode == "viterbi":
            assert out["states"] == want["states"]
    st, out, _ = asgi_request(app, "POST", "/predict", {"x": x})
    want = jm.predict(x)
    assert st == 200
    np.testing.assert_allclose(out["weights"], want["weights"], rtol=0,
                               atol=1e-5)
    assert asgi_request(app, "POST", "/infer", {"x": x[:3]})[0] == 400
    assert asgi_request(app, "POST", "/infer", {})[0] == 400
    assert asgi_request(app, "POST", "/infer", body=b"[1, 2]")[0] == 400
    assert asgi_request(app, "POST", "/infer", body=b"not json{")[0] == 400
    assert asgi_request(app, "GET", "/nope")[0] == 404


def test_asgi_lifespan(app):
    msgs = iter([{"type": "lifespan.startup"},
                 {"type": "lifespan.shutdown"}])
    sent = []

    async def receive():
        return next(msgs)

    async def send(m):
        sent.append(m["type"])

    asyncio.run(app({"type": "lifespan"}, receive, send))
    assert sent == ["lifespan.startup.complete",
                    "lifespan.shutdown.complete"]


def test_asgi_stream_and_metrics(app):
    """/stream with carried state, and the /metrics exposition (the scrape
    itself is not recorded)."""
    rng = np.random.default_rng(1)
    state = None
    for t in range(4):
        st, out, _ = asgi_request(app, "POST", "/stream", {
            "session": "a", "x_t": rng.normal(size=5).tolist(),
            "u_t": rng.normal(size=4).tolist(), "carry_state": True,
            "state": state})
        assert st == 200 and out["t_peek"] == t
        state = out["state"]
    assert [d["t"] for d in out["settled"]] == [1]
    st, out, _ = asgi_request(app, "POST", "/stream",
                              {"session": "a", "finish": True})
    assert st == 200 and [d["t"] for d in out["settled"]] == [2, 3]
    assert asgi_request(app, "POST", "/stream", {"session": ""})[0] == 400

    scope = {"type": "http", "method": "GET", "path": "/metrics",
             "headers": []}
    sent = []

    async def receive():
        return {"type": "http.request", "body": b"", "more_body": False}

    async def send(msg):
        sent.append(msg)

    asyncio.run(app(scope, receive, send))
    text = sent[1]["body"].decode()
    assert dict(sent[0]["headers"])[b"content-type"].startswith(
        b"text/plain")
    assert 'vqhmm_requests_total{endpoint="/stream",status="200"}' in text
    assert 'endpoint="/metrics"' not in text


def test_asgi_sheds_load_with_503(cfg_path, monkeypatch):
    from vqvaehmm_tpu_torch.serve.app import get_model
    from vqvaehmm_tpu_torch.serve.asgi import create_asgi_app

    monkeypatch.setenv("VQHMM_BATCH", "1")
    monkeypatch.setenv("VQHMM_WARMUP_LENGTHS", "")
    monkeypatch.setenv("VQHMM_MAX_QUEUE", "0")
    get_model.cache_clear()
    app = create_asgi_app(cfg_path, device="cpu")  # builds eagerly
    try:
        assert get_model(cfg_path, "cpu").is_batching
        st, out, headers = asgi_request(app, "POST", "/infer",
                                        {"x": [[0.0] * 8] * 5})
        assert st == 503 and "queue full" in out["error"]
        assert headers[b"retry-after"] == b"1"
    finally:
        get_model(cfg_path, "cpu").close()
        get_model.cache_clear()


def test_fastapi_app_builds_and_serves(cfg_path):
    """create_app against the real fastapi, where it is installed."""
    pytest.importorskip("fastapi")
    from fastapi.testclient import TestClient

    from vqvaehmm_tpu_torch.serve.app import create_app, get_model

    try:
        client = TestClient(create_app(cfg_path, device="cpu"))
        assert client.get("/health").json() == {"status": "ok"}
        x = np.random.default_rng(0).normal(size=(5, 20)).tolist()
        r = client.post("/infer", json={"x": x})
        assert r.status_code == 200 and "regime_probs" in r.json()
        assert client.post("/infer", json={"x": x[:2]}).status_code == 400
        r = client.post("/predict", json={"x": x})
        assert r.status_code == 200 and "weights" in r.json()
        r = client.get("/metrics")
        assert r.status_code == 200
        assert 'vqhmm_requests_total{endpoint="/infer",status="200"}' \
            in r.text
    finally:
        get_model.cache_clear()


def test_fastapi_app_serves_via_stub(cfg_path, monkeypatch):
    """create_app's whole wiring (routes, pydantic request models, the
    middleware, HTTPException mapping) against the real fastapi where
    installed, else tests/fastapi_stub.py over the real pydantic."""
    import fastapi_stub

    from vqvaehmm_tpu_torch.serve import app as app_mod

    fastapi_stub.install_stub()
    try:
        client = fastapi_stub.TestClient(app_mod.create_app(cfg_path,
                                                            device="cpu"))
        assert client.get("/health").json() == {"status": "ok"}
        x = np.random.default_rng(0).normal(size=(5, 20)).tolist()
        r = client.post("/infer", json={"x": x})
        assert r.status_code == 200 and "regime_probs" in r.json()
        assert client.post("/infer", json={"x": x[:2]}).status_code == 400
        assert client.post("/infer", json={}).status_code == 422
        r = client.post("/predict", json={"x": x})
        assert r.status_code == 200 and "weights" in r.json()
        r = client.post("/stream", json={"session": "f", "x_t": [0.0] * 5,
                                         "u_t": [0.0] * 4})
        assert r.status_code == 200 and r.json()["t_peek"] == 0
        r = client.post("/infer", json={"x": x}, headers={
            "content-length": str(app_mod.MAX_BODY + 1)})
        assert r.status_code == 413
        assert client.get("/nope").status_code == 404
        monkeypatch.delenv("VQHMM_ENABLE_RELOAD", raising=False)
        assert client.post("/admin/reload", json={}).status_code == 404
        monkeypatch.setenv("VQHMM_ENABLE_RELOAD", "1")
        r = client.post("/admin/reload", json={})
        assert r.status_code == 200 and r.json()["reloaded"] is True
        r = client.get("/metrics")
        assert r.headers["content-type"].startswith("text/plain")
        assert ('vqhmm_requests_total{endpoint="/infer",status="400"}'
                in r.text)
        assert client.get("/metrics").text.count('endpoint="/metrics"') \
            == r.text.count('endpoint="/metrics"')
    finally:
        fastapi_stub.uninstall_stub()
        app_mod.get_model.cache_clear()


def test_gradio_demo_builds(cfg_path):
    pytest.importorskip("gradio")
    from vqvaehmm_tpu_torch.serve.app import get_model
    from vqvaehmm_tpu_torch.serve.gradio_app import build_demo

    try:
        assert build_demo(cfg_path, device="cpu") is not None
    finally:
        get_model.cache_clear()


def test_asgi_malformed_payload_types_are_400(app):
    st, _, _ = asgi_request(app, "POST", "/infer", {"x": {"0": [1.0, 2.0]}})
    assert st == 400


def test_asgi_oversized_body_is_413(cfg_path, monkeypatch):
    from vqvaehmm_tpu_torch.serve import asgi as asgi_mod

    monkeypatch.setattr(asgi_mod, "_MAX_BODY", 1024)
    app = asgi_mod.create_asgi_app(cfg_path, device="cpu")
    st, out, _ = asgi_request(app, "POST", "/infer",
                              {"x": [[0.0] * 2000] * 5})
    assert st == 413 and "exceeds" in out["error"]


def test_fastapi_body_bound_helper():
    from vqvaehmm_tpu_torch.serve.app import MAX_BODY, declared_body_too_large

    assert not declared_body_too_large(None)
    assert not declared_body_too_large("")
    assert not declared_body_too_large(str(MAX_BODY))
    assert not declared_body_too_large("not-a-number")
    assert declared_body_too_large(str(MAX_BODY + 1))


def test_gradio_callback_inference(cfg_path):
    """One text -> (regime, probs, allocation) through the demo's click
    callback, no gradio needed; the probabilities are the served model's
    posterior at the last step."""
    import torch

    from vqvaehmm_tpu_torch.serve.app import get_model
    from vqvaehmm_tpu_torch.serve.gradio_app import (make_infer_fn,
                                                     parse_market_text)

    try:
        infer = make_infer_fn(cfg_path, device="cpu")
        text = "\n".join(" ".join(f"{0.1 * (i + j % 3):.3f}"
                                  for j in range(12)) for i in range(5))
        regime, probs, alloc = infer(text)
        assert regime in ("Bull", "Bear", "Neutral")
        m = get_model(cfg_path, "cpu")
        with torch.inference_mode():
            q = m.model.posterior(torch.from_numpy(parse_market_text(text)))
        np.testing.assert_allclose(list(probs.values()),
                                   q[0, :, -1].numpy(), rtol=0, atol=1e-6)
        assert len(alloc) == 10
        weights = [float(v.rstrip("%")) / 100 for v in alloc.values()]
        assert abs(sum(weights) - 1.0) < 1e-3
        with pytest.raises(ValueError, match="at least"):
            infer("1 2 3")
    finally:
        get_model.cache_clear()


def test_gradio_blocks_wiring_executes(cfg_path):
    import gradio_stub

    from vqvaehmm_tpu_torch.serve.app import get_model

    gradio_stub.install_stub()
    try:
        from vqvaehmm_tpu_torch.serve.gradio_app import (build_demo,
                                                         make_infer_fn)

        demo = build_demo(cfg_path, device="cpu")
        assert demo is not None
        if getattr(sys.modules["gradio"], "__stub__", False):
            buttons = gradio_stub.find_buttons(demo)
            assert len(buttons) == 1 and len(buttons[0].clicks) == 1
            text = "\n".join(" ".join("0.05" for _ in range(8))
                             for _ in range(5))
            out_wired = buttons[0].clicks[0]["fn"](text)
            out_direct = make_infer_fn(cfg_path, device="cpu")(text)
            assert out_wired == out_direct
    finally:
        gradio_stub.uninstall_stub()
        get_model.cache_clear()
