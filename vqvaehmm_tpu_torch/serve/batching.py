"""Dynamic micro-batching for the port's serving surfaces.

Counterpart of vqvaehmm_tpu/serve/batching.py.  BatchingModel wraps
serve/app.py's InferenceModel with a background dispatcher that queues
concurrent mean-field /infer requests (each handler thread blocks on its
own event), groups them by padding bucket, runs the group as one forward
and wakes the callers.

On a CUDA device a dispatch is one launch of kernel A
(ops/fused_infer.py): the group's rows are stacked into one (B, C, pad_to)
float32 tensor and their lengths passed as the per-row `valid_to` vector,
so each row keeps its own time bound.  The batch is not padded to a ladder
of batch sizes as the TPU server pads it: kernel A computes every row
independently of the batch and of the tile width it is launched at, so a
batched row is bit-equal to the same request served solo, and padding rows
would only add work.  On the CPU the forward is the plain version, whose
convolutions may round a row differently in batches of different sizes:
there a batched row agrees with the solo row to float32 rounding.

A dispatch that fails (a kernel error, a shut-down pool) fails every caller
of its group that has no result yet; nothing of the group is computed
again by another path.  Smoothed, filtered and viterbi requests, /predict
and /stream pass through unbatched.
"""

from __future__ import annotations

import concurrent.futures
import os
import sys
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from .app import BATCH_LADDER, DEFAULT_BUCKETS, require_finite_output
from .metrics import METRICS


class ServerBusy(RuntimeError):
    """Raised by BatchingModel.infer when the request queue is at
    max_queue: the server sheds load instead of growing an unbounded
    backlog.  The HTTP surfaces answer it with 503 and Retry-After."""


class DispatcherClosed(RuntimeError):
    """Raised for a request the dispatcher never computed because close()
    stopped it: app.ModelHandle sends such a request to the model a reload
    swapped in."""


class _Pending:
    __slots__ = ("row", "T", "event", "result", "error")

    def __init__(self, row: np.ndarray, T: int):
        self.row = row                # (C, pad_to)
        self.T = T
        self.event = threading.Event()
        self.result = None
        self.error: Optional[Exception] = None


def _time_once(f) -> float:
    t0 = time.perf_counter()
    f()
    return time.perf_counter() - t0


class BatchingModel:
    """Drop-in wrapper around InferenceModel whose .infer() micro-batches
    concurrent mean-field requests into single device calls.

    max_batch:      largest batch a dispatch (clamped to BATCH_LADDER's top).
    max_wait_ms:    how long the dispatcher waits to fill a batch after the
                    first request arrives; 0 batches only what is queued.
    pipeline_depth: dispatches in flight at once (a thread pool).
    max_queue:      requests arriving while this many wait raise ServerBusy
                    (HTTP 503); None keeps the queue unbounded.
    """

    # surfaces check this instead of isinstance, so the check survives
    # proxying through app.ModelHandle
    is_batching = True

    def __init__(self, model, max_batch: int = 16, max_wait_ms: float = 2.0,
                 pipeline_depth: int = 2, max_queue: Optional[int] = None):
        self._inner = model
        self.max_batch = max(1, min(max_batch, BATCH_LADDER[-1]))
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = max_queue
        self._queue: List[_Pending] = []
        self._lock = threading.Lock()
        self._wakeup = threading.Event()
        self._stop = False
        # device calls against requests served
        self.dispatches = 0
        self.requests = 0
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max(1, pipeline_depth))
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        daemon=True)
        self._thread.start()
        self._warn_if_high_rtt()

    def _warn_if_high_rtt(self) -> None:
        """Time a B=1 forward with a host fetch three times at start-up.
        Micro-batching assumes the server sits beside its device: behind a
        slow link the linger window and the round trip serialize, and
        solo dispatch serves more.  Warn where the fastest round trip is
        above VQHMM_RTT_WARN_MS (default 5 ms)."""
        C = self._inner.cfg.model.input_dim
        probe = np.zeros((1, C, DEFAULT_BUCKETS[0]), np.float32)
        lengths = np.array([DEFAULT_BUCKETS[0]], np.int32)

        def f():
            self._inner._forward(probe, lengths)  # fetches to the host

        f()  # builds the kernels on a first call
        rtt = min(_time_once(f) for _ in range(3))
        warn_ms = float(os.environ.get("VQHMM_RTT_WARN_MS", "5"))
        if rtt * 1e3 > warn_ms:
            print(f"WARNING: device dispatch RTT ~{rtt * 1e3:.1f} ms "
                  f"(> {warn_ms:.0f} ms): this server does not look "
                  "co-located with its accelerator; micro-batching "
                  "serializes on that round trip, so consider serving "
                  "without --batch here.", file=sys.stderr, flush=True)

    @property
    def stopped(self) -> bool:
        """True once close() ran: the dispatcher is gone and infer()
        raises (app.ModelHandle.configure_batching rebuilds it)."""
        with self._lock:
            return self._stop

    def reconfigure(self, max_batch: int = 16, max_wait_ms: float = 2.0,
                    max_queue: Optional[int] = None) -> None:
        """New dispatch settings for the live dispatcher, read at its next
        dispatch; queued requests are unaffected."""
        self.max_batch = max(1, min(max_batch, BATCH_LADDER[-1]))
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = max_queue

    def warmup(self, lengths=(200,), exact_modes: bool = True) -> None:
        """Do before serving what a live request would otherwise pay
        first: build the kernels (ops/_build.py), launch kernel A once a
        length bucket at B=1 and at max_batch, and with exact_modes run
        the smoothed, filtered and viterbi paths once a bucket (kernels 11
        and B) and one stream step."""
        inner = self._inner
        if inner.device.type == "cuda":
            from ..ops import _build

            _build.library()
        C = inner.cfg.model.input_dim
        U = inner.cfg.model.u_dim
        buckets = sorted({next((b for b in DEFAULT_BUCKETS if b >= T), T)
                          for T in lengths})
        for pad_to in buckets:
            for B in sorted({1, self.max_batch}):
                inner._forward(np.zeros((B, C, pad_to), np.float32),
                               np.full(B, pad_to, np.int32))
            if exact_modes:
                m = inner.model
                dev = inner.device
                x = torch.zeros((1, C, pad_to), device=dev)
                u = torch.zeros((1, U, pad_to), device=dev)
                lens = torch.tensor([pad_to], dtype=torch.int32, device=dev)
                with torch.inference_mode():
                    m.smoothed_posterior(x, u, lens)
                    m.filtered_posterior(x, u, lens)
                    m.viterbi_decode(x, u, lens)
        if exact_modes and buckets:
            inner._streams.warmup()

    # -- the contract surface (that of InferenceModel) --------------------

    def infer(self, x: List[List[float]], u=None, mode: str = "mean_field"):
        if mode != "mean_field":
            return self._inner.infer(x, u=u, mode=mode)
        padded, T = self._inner._padded(x)  # validates; raises ValueError
        item = _Pending(padded[0], T)
        with self._lock:
            if self._stop:
                raise DispatcherClosed("batching dispatcher shut down")
            if self.max_queue is not None \
                    and len(self._queue) >= self.max_queue:
                raise ServerBusy(
                    f"request queue full ({self.max_queue}); retry")
            self._queue.append(item)
            self.requests += 1
        self._wakeup.set()
        # bounded: a dead dispatcher must fail the caller, not hang it
        if not item.event.wait(timeout=max(60.0, 30 * self.max_wait_s)):
            raise RuntimeError(
                "batched inference timed out (dispatcher stalled?)")
        if item.error is not None:
            raise item.error
        return item.result

    def __getattr__(self, name):
        # everything not overridden (cfg, model, device, checkpoint_loaded,
        # _padded, _forward, _get_head, ...) is the wrapped model's
        return getattr(self._inner, name)

    def predict(self, x: List[List[float]]):
        return self._inner.predict(x)

    def stream(self, *args, **kwargs):
        return self._inner.stream(*args, **kwargs)

    def close(self, drain: bool = False, drain_timeout: float = 30.0):
        """Stop the dispatcher.  drain=True first lets queued requests
        finish (a hot reload must not fail the old model's in-flight
        work); requests still queued past drain_timeout fail."""
        if drain:
            deadline = time.monotonic() + drain_timeout
            while time.monotonic() < deadline:
                with self._lock:
                    if not self._queue:
                        break
                time.sleep(0.005)
        with self._lock:
            self._stop = True
            leftovers, self._queue = self._queue, []
        self._wakeup.set()
        for it in leftovers:
            it.error = DispatcherClosed("batching dispatcher shut down")
            it.event.set()
        self._thread.join(timeout=5)
        self._pool.shutdown(wait=True)

    # -- dispatcher --------------------------------------------------------

    def _take_group(self) -> List[_Pending]:
        """Pop up to max_batch queued items sharing the first item's
        padding bucket."""
        with self._lock:
            if not self._queue:
                return []
            bucket = self._queue[0].row.shape[1]
            group, rest = [], []
            for it in self._queue:
                if len(group) < self.max_batch \
                        and it.row.shape[1] == bucket:
                    group.append(it)
                else:
                    rest.append(it)
            self._queue = rest
            if rest:
                self._wakeup.set()  # more work waiting
            return group

    def _dispatch_loop(self):
        while not self._stop:
            self._wakeup.wait(timeout=0.1)
            self._wakeup.clear()
            if self._stop:
                break
            # linger so a burst lands in one batch; count only the head
            # bucket's items, which is what _take_group can dispatch
            if self.max_wait_s > 0:
                deadline = time.monotonic() + self.max_wait_s
                while time.monotonic() < deadline:
                    with self._lock:
                        if not self._queue:
                            n = 0
                        else:
                            bucket = self._queue[0].row.shape[1]
                            n = sum(1 for it in self._queue
                                    if it.row.shape[1] == bucket)
                    if n >= self.max_batch or n == 0:
                        break
                    time.sleep(min(2e-4, self.max_wait_s / 4))
            group = self._take_group()
            if group:
                try:
                    self._pool.submit(self._run, group)
                except RuntimeError as e:  # the pool shut down meanwhile
                    self._fail(group, e)

    @staticmethod
    def _fail(group: List[_Pending], error: Exception) -> None:
        for it in group:
            if not it.event.is_set():  # delivered results stay valid
                it.error = error
                it.event.set()

    def _run(self, group: List[_Pending]):
        try:
            batch = np.stack([it.row for it in group])
            lengths = np.array([it.T for it in group], np.int32)
            mu, logvar, q = self._inner._forward(batch, lengths)
            with self._lock:  # _run may execute on several pool threads
                self.dispatches += 1
            METRICS.observe_batch(len(group))
            for i, it in enumerate(group):
                T = it.T
                try:
                    # per row: one request's overflow fails that request
                    # alone, not its batch-mates
                    require_finite_output(mu[i, :, :T], logvar[i, :, :T],
                                          q[i, :, :T])
                except ValueError as e:
                    it.error = e
                    it.event.set()
                    continue
                it.result = {"mu": mu[i, :, :T].tolist(),
                             "logvar": logvar[i, :, :T].tolist(),
                             "regime_probs": q[i, :, :T].tolist()}
                it.event.set()
        except Exception as e:  # noqa: BLE001 (every caller gets it)
            self._fail(group, e)
