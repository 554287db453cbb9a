"""Dependency-free ASGI app for the port: the contract of serve/httpd.py
and of the FastAPI app (serve/app.py::create_app) as a plain ASGI
callable.  Counterpart of vqvaehmm_tpu/serve/asgi.py.

  GET  /health        -> {"status": "ok"}
  GET  /metrics       -> Prometheus text exposition (serve/metrics.py)
  POST /infer         -> mu/logvar/regime_probs (+ modes smoothed,
                         filtered, viterbi with exogenous u)
  POST /predict       -> portfolio weights
  POST /stream        -> one frame of a streaming session
  POST /admin/reload  -> hot reload (VQHMM_ENABLE_RELOAD, token-gated)

Bodies past MAX_BODY get 413 and a full micro-batcher queue 503 with
Retry-After.  Model calls block (they wait on the device), so they run in
a worker thread, off the event loop.

    uvicorn --factory vqvaehmm_tpu_torch.serve.asgi:create_asgi_app
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Optional

from .app import MAX_BODY as _MAX_BODY
from .app import default_config_path, get_model, reload_gate
from .batching import ServerBusy
from .metrics import CONTENT_TYPE as _METRICS_CT
from .metrics import METRICS


class _BodyTooLarge(Exception):
    pass


async def _read_body(receive) -> bytes:
    body = b""
    while True:
        msg = await receive()
        body += msg.get("body", b"")
        if len(body) > _MAX_BODY:
            raise _BodyTooLarge(f"request body exceeds {_MAX_BODY} bytes")
        if not msg.get("more_body"):
            return body


async def _respond(send, status: int, payload: dict,
                   content_type: bytes = b"application/json",
                   data: bytes = None) -> None:
    data = json.dumps(payload).encode() if data is None else data
    headers = [(b"content-type", content_type),
               (b"content-length", str(len(data)).encode())]
    if status == 503:  # shed load: the client backs off
        headers.append((b"retry-after", b"1"))
    await send({"type": "http.response.start", "status": status,
                "headers": headers})
    await send({"type": "http.response.body", "body": data})


def _call(config_path: str, device, path: str, req: dict):
    """The blocking model call of one /infer, /predict or /stream body
    (the first one also builds the model)."""
    model = get_model(config_path, device)
    if path == "/stream":
        return model.stream(
            req.get("session"), x_t=req.get("x_t"), u_t=req.get("u_t"),
            finish=bool(req.get("finish", False)), state=req.get("state"),
            carry_state=bool(req.get("carry_state", False)))
    if "x" not in req:
        raise ValueError("missing field 'x'")
    if path == "/infer":
        return model.infer(req["x"], u=req.get("u"),
                           mode=req.get("mode", "mean_field"))
    return model.predict(req["x"])


def create_asgi_app(config_path: Optional[str] = None, device="cuda"):
    """The ASGI callable (config_path None is app.default_config_path()).
    The model is built at the first request, or here already when
    VQHMM_BATCH is set, so no live request pays the batcher's warmup."""
    config_path = config_path or default_config_path()
    if os.environ.get("VQHMM_BATCH", "") not in ("", "0"):
        try:
            get_model(config_path, device)
        except Exception:  # noqa: BLE001 (the first request reports it)
            pass

    async def app(scope, receive, send):
        if scope["type"] == "lifespan":
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
        if scope["type"] != "http":
            raise ValueError(f"unsupported ASGI scope {scope['type']!r}")
        path, method = scope["path"], scope["method"]

        if path == "/metrics" and method == "GET":
            # the scrape itself is not recorded
            await _respond(send, 200, {}, _METRICS_CT.encode(),
                           METRICS.render().encode())
            return

        t0 = time.perf_counter()

        async def respond(status: int, payload: dict) -> None:
            METRICS.observe_request(path, status, time.perf_counter() - t0)
            await _respond(send, status, payload)

        if path == "/health" and method == "GET":
            await respond(200, {"status": "ok"})
            return
        if path == "/admin/reload" and method == "POST":
            # gated before the body is read: a denied client cannot make
            # the worker buffer a body
            hdrs = {k.decode("latin-1").lower(): v.decode("latin-1")
                    for k, v in scope.get("headers", [])}
            denied = reload_gate(hdrs.get("x-reload-token"))
            if denied:
                await respond(denied[0], {"error": denied[1]["detail"]})
                return
            try:
                await _read_body(receive)  # drained; no body expected
            except _BodyTooLarge as e:
                await respond(413, {"error": str(e)})
                return
            try:
                out = await asyncio.to_thread(
                    lambda: get_model(config_path, device).reload())
                await respond(200, out)
            except Exception as e:  # noqa: BLE001 (the old model serves on)
                await respond(500, {"error": f"reload failed: {e}"})
            return
        if path in ("/infer", "/predict", "/stream") and method == "POST":
            try:
                req = json.loads((await _read_body(receive)) or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                out = await asyncio.to_thread(_call, config_path, device,
                                              path, req)
                await respond(200, out)
            except _BodyTooLarge as e:
                await respond(413, {"error": str(e)})
            except ServerBusy as e:  # the batcher's queue is full
                await respond(503, {"error": str(e)})
            except (ValueError, TypeError) as e:
                # JSON errors and malformed payloads are the client's
                await respond(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 (the reference's 500)
                await respond(500, {"error": str(e)})
            return
        await respond(404, {"error": f"no route {method} {path}"})

    return app
