"""Dependency-free HTTP server for the port: GET /health, GET /metrics,
POST /infer and POST /predict, with the contract of
vqvaehmm_tpu/serve/httpd.py.

    python -m vqvaehmm_tpu_torch.serve.httpd --config inference_config.json \
        --port 8000 --device cuda
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .app import MAX_BODY, get_model
from .metrics import CONTENT_TYPE as _METRICS_CT
from .metrics import METRICS


def _make_handler(model):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            try:
                # bare NaN/Infinity tokens are not valid JSON
                body = json.dumps(payload, allow_nan=False).encode()
            except ValueError:
                code = 500
                body = json.dumps(
                    {"detail": "non-finite values in response"}).encode()
            METRICS.observe_request(self.path, code,
                                    time.perf_counter() - self._t0)
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._t0 = time.perf_counter()
            if self.path == "/metrics":
                # the scrape itself is not recorded
                body = METRICS.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", _METRICS_CT)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/health":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"detail": "not found"})

        def do_POST(self):
            self._t0 = time.perf_counter()
            if self.path not in ("/infer", "/predict"):
                self._send(404, {"detail": "not found"})
                return
            try:
                if "chunked" in (self.headers.get("Transfer-Encoding")
                                 or "").lower():
                    self._send(411, {"detail": "Content-Length required"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                if not 0 <= length <= MAX_BODY:
                    self._send(400, {"detail": "bad Content-Length"})
                    return
                # always drained: replying with bytes left unread risks a
                # reset that discards the response
                req = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(req, dict):
                    self._send(400, {"detail": "body must be a JSON "
                                               "object"})
                    return
                if "x" not in req:
                    self._send(400, {"detail": "missing field 'x'"})
                    return
                if self.path == "/infer":
                    self._send(200, model.infer(
                        req["x"], u=req.get("u"),
                        mode=req.get("mode", "mean_field")))
                else:
                    self._send(200, model.predict(req["x"]))
            except (ValueError, TypeError) as e:
                # malformed payloads and bad shapes are client errors
                self._send(400, {"detail": str(e)})
            except Exception as e:  # noqa: BLE001 (the reference's 500)
                self._send(500, {"detail": str(e)})

        def log_message(self, *args):  # quiet
            pass

    return Handler


def serve(config_path: str = "inference_config.json", host: str = "0.0.0.0",
          port: int = 8000, background: bool = False, device="cuda"
          ) -> Optional[ThreadingHTTPServer]:
    """Serve the configured model on `device` ("cuda" unless the CPU is
    asked for).  background=True returns the running server; call its
    shutdown() and server_close() to stop it."""
    model = get_model(config_path, device)
    httpd = ThreadingHTTPServer((host, port), _make_handler(model))
    httpd.vqhmm_model = model
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
    return None


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--config", default="inference_config.json")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    a = p.parse_args()
    print(f"starting on {a.host}:{a.port} ({a.device}) ...", flush=True)
    serve(a.config, a.host, a.port, device=a.device)
