"""Profiling and tracing hooks (counterpart of
vqvaehmm_tpu/utils/profiling.py): a torch.profiler trace around any code
block, the program's own host spans and counters, a step timer with
throughput accounting, device memory statistics and an append-only JSONL
metrics log.

Spans.  `with span("train.step"): ...` marks where the host's time goes
at a layer's boundary.  A span records only while a torch.profiler
profile is active on the calling thread (the flag PyTorch's own
record_function reads) or inside a `recording()` block (any thread);
otherwise `span` returns one shared no-op and allocates nothing.  A
recorded span holds its name, its start and end on time.perf_counter()
(the clock a benchmark's host spans and a marker-aligned device trace
share), the index of its parent (None at the top) and a root id, the
index of the top-level span it runs under; spans nest per thread.  They
go into a bounded buffer, oldest dropped first (`counts.dropped_spans`);
`spans_between(start, end)` returns those inside an interval with their
self time.  `trace(log_dir)` writes the block's spans as `spans.jsonl`.

Counters.  `counts` holds always-on integers, read as
`utils.profiling:counts.<name>`: `host_syncs` (blocking host waits on the
device: each also a `host.sync` span, `host_sync(device)`), `plans_made`
(launch-plan cache misses, `cache.plan` spans), `packs_made` (weight
packs, `cache.pack` spans) and `dropped_spans`.  They only rise."""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, replace
from typing import Deque, Dict, List, Optional

import torch

# spans the buffer keeps: some 3,500 training steps (4 spans a step, 15 an
# epoch) or 2,700 scoring requests (5 or 6 spans each)
SPAN_BUFFER = 16384

_profiler_enabled = torch._C._autograd._profiler_enabled


class Counts:
    """The always-on counters (module docstring); `add` is thread-safe."""

    NAMES = ("host_syncs", "plans_made", "packs_made", "dropped_spans")

    def __init__(self):
        self._lock = threading.Lock()
        for name in self.NAMES:
            setattr(self, name, 0)

    def add(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)


counts = Counts()


@dataclass
class Span:
    """One recorded span; times in seconds on time.perf_counter()."""
    index: int
    name: str
    start: float
    end: float
    parent: Optional[int]
    root: int
    thread: int
    self_s: float = 0.0

    @property
    def duration_s(self) -> float:
        return self.end - self.start


class _Off:
    """The no-op every span site gets while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_buffer: Deque[Span] = collections.deque()
_buffer_lock = threading.Lock()
_index = itertools.count()
_local = threading.local()
_recording = 0


class _Open:
    """A span being recorded on this thread."""
    __slots__ = ("name", "index", "parent", "root", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.index = next(_index)
        if stack:
            self.parent, self.root = stack[-1].index, stack[-1].root
        else:
            self.parent, self.root = None, self.index
        stack.append(self)
        self.start = time.perf_counter()
        return None

    def __exit__(self, *exc):
        end = time.perf_counter()
        _local.stack.pop()
        rec = Span(self.index, self.name, self.start, end, self.parent,
                   self.root, threading.get_ident())
        with _buffer_lock:
            if len(_buffer) >= SPAN_BUFFER:
                _buffer.popleft()
                counts.add("dropped_spans")
            _buffer.append(rec)
        return False


def span(name: str):
    """A context manager marking a host span `name` (module docstring):
    recorded under an active torch.profiler profile or `recording()`, the
    shared no-op otherwise."""
    if _recording or _profiler_enabled():
        return _Open(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """Record spans inside the block, on every thread, with no profiler."""
    global _recording
    with _buffer_lock:
        _recording += 1
    try:
        yield
    finally:
        with _buffer_lock:
            _recording -= 1


def waits_on(device) -> bool:
    """Whether a blocking copy or synchronise for `device` waits on a
    device (a CUDA device; the CPU has nothing to wait for).  A function
    of its own so that the CPU tests can stand a waiting device in."""
    return torch.device(device).type == "cuda"


def host_sync(device):
    """The span of a blocking host wait on `device`, counted in
    `counts.host_syncs`; the shared no-op, uncounted, where nothing waits
    (waits_on)."""
    if not waits_on(device):
        return _OFF
    counts.add("host_syncs")
    return span("host.sync")


def counted(name: str, counter: str):
    """span(name) of a cache miss, counted in `counts.<counter>`."""
    counts.add(counter)
    return span(name)


def spans_between(start: float, end: float) -> List[Span]:
    """The kept spans lying inside [start, end] (perf_counter seconds), in
    the order they opened, each with its self time: its duration less its
    kept children's."""
    with _buffer_lock:
        got = [s for s in _buffer if s.start >= start and s.end <= end]
    got.sort(key=lambda s: s.index)
    child: Dict[int, float] = {}
    for s in got:
        if s.parent is not None:
            child[s.parent] = child.get(s.parent, 0.0) + s.duration_s
    return [replace(s, self_s=s.duration_s - child.get(s.index, 0.0))
            for s in got]


def clear_spans() -> None:
    """Empty the span buffer (the counters stay)."""
    with _buffer_lock:
        _buffer.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block (the host's operators
    and, where a GPU is present, the device's kernels) and write it as a
    Chrome trace, `trace.json` in log_dir (Perfetto or chrome://tracing
    read it), and the program's spans of the block as `spans.jsonl`, one
    JSON object a span (`Span`'s fields, times in perf_counter seconds).
    Work queued on the device inside the block is traced only if it
    finishes inside it: synchronise before leaving."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        start = time.perf_counter()
        yield log_dir
        end = time.perf_counter()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.jsonl"), "w") as f:
        for s in spans_between(start, end):
            f.write(json.dumps(s.__dict__) + "\n")


class StepTimer:
    """Wall-clock step timing and items a second, with warm-up excluded.

        timer = StepTimer(warmup=3)
        for batch in data:
            with timer.step(items=batch_size):
                ...
        print(timer.summary())

    The block must end with the device's work done (a host sync) for the
    time to be the step's and not its enqueue."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: List[float] = []
        self.items: List[int] = []

    @contextlib.contextmanager
    def step(self, items: int = 1):
        t0 = time.perf_counter()
        yield
        self.times.append(time.perf_counter() - t0)
        self.items.append(items)

    def summary(self) -> Dict[str, float]:
        times = self.times[self.warmup:]
        items = self.items[self.warmup:]
        if not times:
            return {"steps": 0}
        total = sum(times)
        return {
            "steps": len(times),
            "mean_step_s": total / len(times),
            "p50_step_s": sorted(times)[len(times) // 2],
            "items_per_sec": sum(items) / total,
        }


def device_memory_stats() -> Dict[str, Optional[Dict]]:
    """Memory statistics of each CUDA device under the JAX package's keys
    (XLA's memory_stats: bytes_in_use, peak_bytes_in_use, bytes_reserved,
    peak_bytes_reserved, num_allocs, bytes_limit) from
    torch.cuda.memory_stats; {"cpu": None} without a GPU, as the JAX
    package reports a device without statistics."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_reserved": s.get("reserved_bytes.all.current", 0),
            "peak_bytes_reserved": s.get("reserved_bytes.all.peak", 0),
            "num_allocs": s.get("allocation.all.allocated", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


class MetricsLogger:
    """Append-only JSONL metrics log."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a")

    def log(self, step: int, **metrics):
        rec = {"step": step, "time": time.time(), **metrics}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
