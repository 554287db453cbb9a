"""Dependency-free serving metrics in the Prometheus text format.

A verbatim copy of vqvaehmm_tpu/serve/metrics.py (pure Python), kept
until the JAX package can be imported without JAX (ROADMAP.md queue 1,
item 0).  Of the series below, the port's server records the request
counters and latencies and the checkpoint gauge; it has no micro-batcher
and no streaming sessions yet.

Reference gap: the reference's deploy notes defer observability to
"Prometheus if desired" (deploy/README.md:27-29) and implement nothing;
its serving surfaces expose no counters at all (SURVEY.md section 5,
"Metrics / logging / observability": stdout prints only).  This module
closes that: a thread-safe in-process registry with the standard
exposition format (text/plain; version=0.0.4), no client-library
dependency, exposed as GET /metrics by all three serving surfaces
(serve/app.py FastAPI, serve/asgi.py, serve/httpd.py).

Series:
  vqhmm_requests_total{endpoint,status}   counter, per route x HTTP status
  vqhmm_request_seconds{endpoint}         histogram, request latency
  vqhmm_batch_size                        histogram, coalesced batch size
                                          per device dispatch (only when
                                          the micro-batcher is on)
  vqhmm_stream_sessions                   gauge, live streaming sessions
  vqhmm_checkpoint_loaded                 gauge, 1 iff weights came from a
                                          checkpoint (0 = random init)

Scope is per PROCESS: under `gunicorn -w N` each worker owns its own
registry — scrape every worker (or aggregate at the collector), the
standard Prometheus multi-worker posture.  Unknown request paths are
normalized to endpoint="other" so hostile path scans cannot explode
label cardinality.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Tuple

# latency buckets: sub-ms cache hits through multi-second cold compiles
REQUEST_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)
# the micro-batcher's dispatch ladder (serve/batching._BATCH_LADDER)
BATCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)

# routes that keep their own endpoint label; anything else is "other"
KNOWN_ENDPOINTS = ("/health", "/infer", "/predict", "/stream")


def normalize_endpoint(path: str) -> str:
    return path if path in KNOWN_ENDPOINTS else "other"


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a trailing .0."""
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class _Histogram:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * len(buckets)  # cumulative at render time
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
                break
        self.sum += v
        self.count += 1

    def render(self, name: str, label: str) -> List[str]:
        sel = f"{{{label},le=" if label else "{le="
        out, cum = [], 0
        for le, c in zip(self.buckets, self.counts):
            cum += c
            out.append(f"{name}_bucket{sel}\"{_fmt(le)}\"}} {cum}")
        out.append(f"{name}_bucket{sel}\"+Inf\"}} {self.count}")
        tail = f"{{{label}}}" if label else ""
        out.append(f"{name}_sum{tail} {repr(self.sum)}")
        out.append(f"{name}_count{tail} {self.count}")
        return out


class MetricsRegistry:
    """Thread-safe process-wide registry (module singleton: METRICS)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._requests: Dict[Tuple[str, int], int] = {}
        self._latency: Dict[str, _Histogram] = {}
        self._batch = _Histogram(BATCH_BUCKETS)
        # gauges are CALLBACKS read at scrape time (live values, no
        # per-request bookkeeping); name -> (fn, help text)
        self._gauges: Dict[str, Tuple[Callable[[], float], str]] = {}

    def observe_request(self, path: str, status: int,
                        seconds: float) -> None:
        ep = normalize_endpoint(path)
        with self._lock:
            key = (ep, int(status))
            self._requests[key] = self._requests.get(key, 0) + 1
            hist = self._latency.get(ep)
            if hist is None:
                hist = self._latency[ep] = _Histogram(REQUEST_BUCKETS)
            hist.observe(seconds)

    def observe_batch(self, size: int) -> None:
        with self._lock:
            self._batch.observe(float(size))

    def register_gauge(self, name: str, fn: Callable[[], float],
                       help_text: str) -> None:
        """Re-registering a name replaces the callback (a reloaded model
        must not leave a stale closure reporting dead state)."""
        with self._lock:
            self._gauges[name] = (fn, help_text)

    def render(self) -> str:
        with self._lock:
            lines = [
                "# HELP vqhmm_requests_total Total HTTP requests served.",
                "# TYPE vqhmm_requests_total counter",
            ]
            for (ep, status), n in sorted(self._requests.items()):
                lines.append(
                    f'vqhmm_requests_total{{endpoint="{ep}",'
                    f'status="{status}"}} {n}')
            lines += [
                "# HELP vqhmm_request_seconds HTTP request latency.",
                "# TYPE vqhmm_request_seconds histogram",
            ]
            for ep in sorted(self._latency):
                lines += self._latency[ep].render(
                    "vqhmm_request_seconds", f'endpoint="{ep}"')
            lines += [
                "# HELP vqhmm_batch_size Coalesced requests per device "
                "dispatch (micro-batcher).",
                "# TYPE vqhmm_batch_size histogram",
            ]
            lines += self._batch.render("vqhmm_batch_size", "")
            gauges = list(self._gauges.items())
        # gauge callbacks run OUTSIDE the lock: they may take their own
        # locks (e.g. StreamManager's session table) and must not be able
        # to deadlock against a concurrent observe_* call
        for name, (fn, help_text) in sorted(gauges):
            try:
                v = float(fn())
            except Exception:
                continue  # a dying gauge must not break the whole scrape
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(v)}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Tests only: forget all samples and gauges."""
        with self._lock:
            self._requests.clear()
            self._latency.clear()
            self._batch = _Histogram(BATCH_BUCKETS)
            self._gauges.clear()


METRICS = MetricsRegistry()

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
