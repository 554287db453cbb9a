"""Profiling and tracing hooks (counterpart of
vqvaehmm_tpu/utils/profiling.py): a torch.profiler trace around any code
block, a step timer with throughput accounting, device memory statistics
and an append-only JSONL metrics log."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block (the host's operators
    and, where a GPU is present, the device's kernels) and write it as a
    Chrome trace, `trace.json` in log_dir (Perfetto or chrome://tracing
    read it).  Work queued on the device inside the block is traced only
    if it finishes inside it: synchronise before leaving."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
    import torch

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
