"""Dependency-free HTTP server for the port, with the contract of
vqvaehmm_tpu/serve/httpd.py: GET /health and /metrics; POST /infer,
/predict, /stream and /admin/reload; 503 with Retry-After when the
micro-batcher's queue is full.

    python -m vqvaehmm_tpu_torch.serve.httpd --config inference_config.json \
        --port 8000 --device cuda [--batch --max-batch 16 --max-wait-ms 2]

In the foreground the server stops on SIGTERM after its in-flight
requests and the batcher's queue are done, and exits 0.
"""

from __future__ import annotations

import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .app import MAX_BODY, get_model, reload_gate
from .batching import ServerBusy
from .metrics import CONTENT_TYPE as _METRICS_CT
from .metrics import METRICS


class _Server(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 makes every client
    # of a burst past the fifth wait out a 1 s SYN retransmit
    request_queue_size = 128


def _make_handler(model):  # a ModelHandle, InferenceModel or BatchingModel
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
            if code == 503:  # shed load: the client backs off
                self.send_header("Retry-After", "1")
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
            if self.path not in ("/infer", "/predict", "/stream",
                                 "/admin/reload"):
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
                body = self.rfile.read(length)
                if self.path == "/admin/reload":
                    denied = reload_gate(self.headers.get("X-Reload-Token"))
                    if denied:
                        self._send(*denied)
                        return
                    try:
                        self._send(200, model.reload())
                    except Exception as e:  # noqa: BLE001 (old model serves)
                        self._send(500, {"detail": f"reload failed: {e}"})
                    return
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    self._send(400, {"detail": "body must be a JSON "
                                               "object"})
                    return
                if self.path == "/stream":
                    self._send(200, model.stream(
                        req.get("session"), x_t=req.get("x_t"),
                        u_t=req.get("u_t"),
                        finish=bool(req.get("finish", False)),
                        state=req.get("state"),
                        carry_state=bool(req.get("carry_state", False))))
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
            except ServerBusy as e:  # the batcher's queue is full
                self._send(503, {"detail": str(e)})
            except (ValueError, TypeError) as e:
                # malformed payloads and bad shapes are client errors
                self._send(400, {"detail": str(e)})
            except Exception as e:  # noqa: BLE001 (the reference's 500)
                self._send(500, {"detail": str(e)})

        def log_message(self, *args):  # quiet
            pass

    return Handler


def serve(config_path: str = "inference_config.json", host: str = "0.0.0.0",
          port: int = 8000, background: bool = False, batch: bool = False,
          max_batch: int = 16, max_wait_ms: float = 2.0,
          warmup_lengths=(200,), max_queue: Optional[int] = None,
          pipeline_depth: int = 2, device="cuda"
          ) -> Optional[ThreadingHTTPServer]:
    """Serve the configured model on `device` ("cuda" unless the CPU is
    asked for).  batch=True micro-batches concurrent mean-field /infer
    requests (serve/batching.py) on the process-wide handle, so a reload
    rebuilds and re-warms the batcher; warmup_lengths are the request
    lengths whose buckets are warmed before serving.  Where VQHMM_BATCH
    already batches the handle, its settings stand and warmup_lengths are
    still warmed.

    background=True returns the running server, its model as
    `server.vqhmm_model`; call its shutdown() and server_close(), and the
    model's close() to stop a batcher (which retires batching for every
    surface of this process until the next serve(batch=True) or reload)."""
    model = get_model(config_path, device)
    if batch:
        model.configure_batching(max_batch=max_batch,
                                 max_wait_ms=max_wait_ms,
                                 warmup_lengths=warmup_lengths,
                                 max_queue=max_queue,
                                 pipeline_depth=pipeline_depth)
    elif warmup_lengths and model.is_batching:
        model.warmup(warmup_lengths)
    httpd = _Server((host, port), _make_handler(model))
    httpd.vqhmm_model = model
    if background:
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd

    def _graceful(signum, frame):
        print("SIGTERM: draining and shutting down", file=sys.stderr,
              flush=True)
        # shutdown() waits for serve_forever, so not on its own thread
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    # with daemon handler threads server_close() would join none of them
    httpd.daemon_threads = False
    try:
        prev = signal.signal(signal.SIGTERM, _graceful)
    except ValueError:  # not the main thread: the default action stands
        prev = None
    try:
        print(f"serving {config_path} on {host}:{port} ({device})",
              flush=True)
        httpd.serve_forever()
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        httpd.server_close()  # joins the in-flight handler threads
        if model.is_batching:
            model.close(drain=True)
    return None


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--config", default="inference_config.json")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda",
                   help="torch device; the CPU only when asked for")
    p.add_argument("--batch", action="store_true",
                   help="micro-batch concurrent /infer requests")
    p.add_argument("--max-batch", type=int, default=16)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--max-queue", type=int, default=None,
                   help="shed load (503) beyond this many queued "
                        "requests; default unbounded")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="batched device calls kept in flight; default 2")
    a = p.parse_args()
    print(f"starting on {a.host}:{a.port} ({a.device})"
          + (f", micro-batching <= {a.max_batch}" if a.batch else "")
          + " ...", flush=True)
    serve(a.config, a.host, a.port, batch=a.batch, max_batch=a.max_batch,
          max_wait_ms=a.max_wait_ms, max_queue=a.max_queue,
          pipeline_depth=a.pipeline_depth, device=a.device)
