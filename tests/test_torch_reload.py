"""Hot reload of the port's serving model (vqvaehmm_tpu_torch.serve.app.
ModelHandle) on the CPU, case by case after tests/test_reload.py."""

import asyncio
import gc
import json
import threading
import time
import weakref

import numpy as np
import pytest

import tests.torch_port  # noqa: F401  (one torch thread per worker)
from tests.torch_port import SMALL, free_port, post_json

CFG = {"model": SMALL}


def _write_ckpt(path, seed, hidden_dim=8):
    import jax

    from vqvaehmm_tpu import make_model
    from vqvaehmm_tpu.data.checkpoint import save_params_npz

    cfg = dict(SMALL, hidden_dim=hidden_dim)
    save_params_npz(str(path), make_model(**cfg).init(
        jax.random.PRNGKey(seed)))


def _config(tmp_path, **extra):
    ckpt = tmp_path / "weights.npz"
    _write_ckpt(ckpt, seed=0)
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(dict(CFG, checkpoint_path=str(ckpt),
                                        **extra)))
    return str(cfg_path), ckpt


@pytest.fixture()
def handle(tmp_path):
    from vqvaehmm_tpu_torch.serve.app import get_model

    cfg_path, ckpt = _config(tmp_path)
    get_model.cache_clear()
    yield get_model(cfg_path, "cpu"), ckpt
    get_model.cache_clear()


def _x(seed, T):
    return np.random.default_rng(seed).normal(size=(5, T)).tolist()


def test_reload_swaps_weights(handle):
    """After a reload the handle serves the new checkpoint, equal to a
    model built fresh from it."""
    from vqvaehmm_tpu_torch.serve.app import InferenceModel

    m, ckpt = handle
    x = _x(3, 21)
    q_before = np.array(m.infer(x)["regime_probs"])
    _write_ckpt(ckpt, seed=1)
    info = m.reload()
    assert info == {"reloaded": True, "checkpoint_loaded": True,
                    "batching": False}
    q_after = np.array(m.infer(x)["regime_probs"])
    assert np.abs(q_after - q_before).max() > 1e-6
    fresh = InferenceModel(m._config_path, device="cpu")
    np.testing.assert_array_equal(
        q_after, np.array(fresh.infer(x)["regime_probs"]))


def test_failed_reload_keeps_old_model(handle):
    m, ckpt = handle
    x = _x(4, 17)
    q_before = np.array(m.infer(x)["regime_probs"])
    _write_ckpt(ckpt, seed=2, hidden_dim=16)  # does not fit the config
    with pytest.raises(ValueError, match="do not match"):
        m.reload()
    np.testing.assert_array_equal(np.array(m.infer(x)["regime_probs"]),
                                  q_before)


def test_reload_rebuilds_and_retires_batcher(handle, monkeypatch):
    m, _ = handle
    monkeypatch.setenv("VQHMM_BATCH", "1")
    monkeypatch.setenv("VQHMM_WARMUP_LENGTHS", "")
    assert m.reload()["batching"] is True
    old = m._inner
    assert old._thread.is_alive()
    try:
        assert m.reload()["batching"] is True
        old._thread.join(timeout=5)
        assert not old._thread.is_alive() and old.stopped
        assert np.array(m.infer(_x(5, 9))["regime_probs"]).shape == (3, 9)
    finally:
        m._inner.close()


def test_carried_stream_state_survives_reload(handle):
    """Sessions drop on reload, but a carry_state client resumes exactly:
    the settled columns of an uninterrupted session."""
    m, _ = handle
    rng = np.random.default_rng(6)
    frames = [(rng.normal(size=5).tolist(), rng.normal(size=4).tolist())
              for _ in range(4)]
    out = None
    for x_t, u_t in frames[:2]:
        out = m.stream("s1", x_t=x_t, u_t=u_t, carry_state=True)
    m.reload()
    assert m._streams.n_sessions() == 0
    resumed = m.stream("s1", x_t=frames[2][0], u_t=frames[2][1],
                       state=out["state"], carry_state=True)
    assert resumed["resumed"] is True
    solo = None
    for x_t, u_t in frames[:3]:
        solo = m.stream("solo", x_t=x_t, u_t=u_t)
    assert [c["t"] for c in resumed["settled"]] \
        == [c["t"] for c in solo["settled"]]
    for a, b in zip(resumed["settled"], solo["settled"]):
        np.testing.assert_array_equal(a["regime_probs"], b["regime_probs"])


def test_failed_reload_restores_metrics_gauges(handle, monkeypatch):
    """A candidate that fails after its construction bound the /metrics
    gauges leaves them bound to the model still serving."""
    from vqvaehmm_tpu_torch.serve import batching
    from vqvaehmm_tpu_torch.serve.metrics import METRICS

    m, _ = handle
    rng = np.random.default_rng(8)
    m.stream("live", x_t=rng.normal(size=5).tolist(),
             u_t=rng.normal(size=4).tolist())  # one session

    def broken_warmup(self, lengths=(200,), exact_modes=True):
        raise ValueError("warmup failed")

    monkeypatch.setenv("VQHMM_BATCH", "1")
    monkeypatch.setenv("VQHMM_WARMUP_LENGTHS", "32")
    monkeypatch.setattr(batching.BatchingModel, "warmup", broken_warmup)
    with pytest.raises(ValueError, match="warmup failed"):
        m.reload()
    assert "vqhmm_stream_sessions 1" in METRICS.render()
    assert not m.is_batching


def test_reload_drains_queued_requests(handle, monkeypatch):
    """A request already queued in the old micro-batcher when the swap
    happens completes on the old model (close(drain=True))."""
    m, _ = handle
    monkeypatch.setenv("VQHMM_BATCH", "1")
    monkeypatch.setenv("VQHMM_WARMUP_LENGTHS", "")
    monkeypatch.setenv("VQHMM_MAX_WAIT_MS", "150")  # the queue holds
    m.reload()
    x = _x(9, 11)
    old = m._inner
    base = old.requests
    results, errors = [], []

    def worker():
        try:
            results.append(old.infer(x))  # pinned to the old batcher
        except Exception as e:  # noqa: BLE001 (the failure looked for)
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    for _ in range(1000):
        with old._lock:
            if old._queue or old.requests > base:
                break
        time.sleep(0.001)
    m.reload()
    t.join(timeout=30)
    try:
        assert not t.is_alive() and not errors, errors
        assert np.array(results[0]["regime_probs"]).shape == (3, 11)
        assert old.stopped
    finally:
        m._inner.close()


def test_configure_batching_survives_reload(handle):
    m, _ = handle
    m.configure_batching(max_batch=4, max_wait_ms=1.0, warmup_lengths=(32,))
    assert m.is_batching
    old = m._inner
    info = m.reload()
    try:
        assert info["batching"] is True
        assert m._inner is not old and m.is_batching
        assert m._inner.max_batch == 4
        old._thread.join(timeout=5)
        assert not old._thread.is_alive()
        assert np.array(m.infer(_x(10, 8))["regime_probs"]).shape == (3, 8)
    finally:
        m._inner.close()


def test_reloaded_models_are_garbage(handle, monkeypatch):
    """After reloads nothing holds the old models or their batchers."""
    m, _ = handle
    monkeypatch.setenv("VQHMM_BATCH", "1")
    monkeypatch.setenv("VQHMM_WARMUP_LENGTHS", "32")
    m.reload()
    refs = []
    try:
        for _ in range(3):
            m.stream("s", x_t=[0.0] * 5, u_t=[0.0] * 4)
            m.infer(_x(12, 30))
            refs.append((weakref.ref(m._inner), weakref.ref(m.model)))
            m.reload()
        gc.collect()
        assert all(r() is None for pair in refs for r in pair)
    finally:
        m._inner.close()


def test_http_reload_gating_and_swap(tmp_path, monkeypatch):
    """/admin/reload: 404 unless enabled, 403 on a bad token, and with the
    right token a swap while the server stays up."""
    from vqvaehmm_tpu_torch.serve.app import get_model
    from vqvaehmm_tpu_torch.serve.httpd import serve

    cfg_path, ckpt = _config(tmp_path)
    get_model.cache_clear()
    port = free_port()
    httpd = serve(cfg_path, host="127.0.0.1", port=port, background=True,
                  device="cpu")
    base = f"http://127.0.0.1:{port}"
    try:
        x = _x(7, 13)
        _, out1, _ = post_json(base + "/infer", {"x": x})
        monkeypatch.delenv("VQHMM_ENABLE_RELOAD", raising=False)
        assert post_json(base + "/admin/reload")[0] == 404
        monkeypatch.setenv("VQHMM_ENABLE_RELOAD", "1")
        monkeypatch.setenv("VQHMM_RELOAD_TOKEN", "sesame")
        assert post_json(base + "/admin/reload",
                         headers={"X-Reload-Token": "wrong"})[0] == 403
        _write_ckpt(ckpt, seed=1)
        status, info, _ = post_json(base + "/admin/reload",
                                    headers={"X-Reload-Token": "sesame"})
        assert status == 200 and info["reloaded"] is True
        _, out2, _ = post_json(base + "/infer", {"x": x})
        assert np.abs(np.array(out2["regime_probs"])
                      - np.array(out1["regime_probs"])).max() > 1e-6
        _write_ckpt(ckpt, seed=2, hidden_dim=16)
        status, body, _ = post_json(base + "/admin/reload",
                                    headers={"X-Reload-Token": "sesame"})
        assert status == 500 and "reload failed" in body["detail"]
        _, out3, _ = post_json(base + "/infer", {"x": x})
        assert out3 == out2  # the old model serves on
    finally:
        httpd.shutdown()
        httpd.server_close()
        get_model.cache_clear()


def test_asgi_reload_route(tmp_path, monkeypatch):
    from vqvaehmm_tpu_torch.serve import asgi as asgi_mod
    from vqvaehmm_tpu_torch.serve.app import get_model

    cfg_path, ckpt = _config(tmp_path)
    get_model.cache_clear()
    app = asgi_mod.create_asgi_app(cfg_path, device="cpu")

    def call(path, headers=(), body=b"{}"):
        scope = {"type": "http", "method": "POST", "path": path,
                 "headers": list(headers)}
        sent = []

        async def receive():
            return {"type": "http.request", "body": body,
                    "more_body": False}

        async def send(msg):
            sent.append(msg)

        asyncio.run(app(scope, receive, send))
        return sent[0]["status"], json.loads(sent[1]["body"])

    try:
        monkeypatch.delenv("VQHMM_ENABLE_RELOAD", raising=False)
        assert call("/admin/reload")[0] == 404
        monkeypatch.setenv("VQHMM_ENABLE_RELOAD", "1")
        monkeypatch.setenv("VQHMM_RELOAD_TOKEN", "t0k")
        assert call("/admin/reload")[0] == 403
        _write_ckpt(ckpt, seed=1)
        status, info = call("/admin/reload",
                            headers=[(b"x-reload-token", b"t0k")])
        assert status == 200 and info["reloaded"] is True
        # an oversized body is the client's fault: 413
        monkeypatch.setattr(asgi_mod, "_MAX_BODY", 8)
        status, body = call("/admin/reload", body=b"x" * 64,
                            headers=[(b"x-reload-token", b"t0k")])
        assert status == 413, (status, body)
    finally:
        get_model.cache_clear()


def test_configure_batching_applies_to_live_and_rebuilds_closed(handle):
    m, _ = handle
    m.configure_batching(max_batch=4, max_wait_ms=1.0, warmup_lengths=(),
                         max_queue=None)
    live = m._inner
    m.configure_batching(max_batch=8, max_wait_ms=3.0, warmup_lengths=(),
                         max_queue=5)
    assert m._inner is live  # reconfigured in place
    assert live.max_batch == 8 and live.max_queue == 5
    assert abs(live.max_wait_s - 0.003) < 1e-9
    live.close()  # a server teardown
    m.configure_batching(max_batch=2, max_wait_ms=1.0, warmup_lengths=())
    assert m._inner is not live and m.is_batching and not m._inner.stopped
    try:
        assert np.array(m.infer(_x(11, 9))["regime_probs"]).shape == (3, 9)
    finally:
        m._inner.close()


def test_vq_family_is_served_solo_under_the_handle(tmp_path, capsys):
    """A `model.family: vqvae` config gets serve/vq.py's model behind the
    handle; asking for batching warns and keeps it solo."""
    from vqvaehmm_tpu_torch.serve.app import ModelHandle
    from vqvaehmm_tpu_torch.serve.vq import VQInferenceModel

    cfg_path = tmp_path / "vq.json"
    cfg_path.write_text(json.dumps({
        "model": dict(SMALL, family="vqvae"),
        "vq": {"num_codes": 8, "latent_dim": 4}}))
    h = ModelHandle(str(cfg_path), device="cpu")
    assert isinstance(h._inner, VQInferenceModel) and not h.is_batching
    h.configure_batching(max_batch=4, warmup_lengths=())
    assert not h.is_batching
    assert "solo" in capsys.readouterr().err
    out = h.infer(_x(13, 12))
    assert len(out["codes"]) == 12
    assert h.reload()["batching"] is False
    with pytest.raises(ValueError, match="streaming"):
        h.stream("s", x_t=[0.0] * 5, u_t=[0.0] * 4)


def test_requests_through_reloads_never_fail(handle):
    """A request that took the old batcher just before a reload and
    reaches it after the reload closed it, never computed, is served by
    the model swapped in (ModelHandle.infer); a request to a closed
    batcher the handle still holds fails."""
    from vqvaehmm_tpu_torch.serve.batching import DispatcherClosed

    m, _ = handle
    m.configure_batching(max_batch=4, max_wait_ms=1.0, warmup_lengths=())
    old = m._inner
    inside, release = threading.Event(), threading.Event()
    padded = old._inner._padded

    def parked(x):  # the request has chosen the old batcher
        inside.set()
        release.wait(timeout=30)
        return padded(x)

    old._inner._padded = parked
    x = _x(14, 16)
    out, errors = [], []

    def request():
        try:
            out.append(m.infer(x))
        except Exception as e:  # noqa: BLE001 (the failure looked for)
            errors.append(e)

    t = threading.Thread(target=request)
    t.start()
    try:
        assert inside.wait(timeout=30)
        m.reload()
        assert old.stopped and m._inner is not old
    finally:
        release.set()
        t.join(timeout=30)
    try:
        assert not t.is_alive() and not errors, errors
        assert out[0] == m.infer(x)
        assert m.dispatches >= 1
    finally:
        m._inner.close()
    with pytest.raises(DispatcherClosed):
        m.infer(x)
