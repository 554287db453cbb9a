"""The port's profiling hooks (vqvaehmm_tpu_torch/utils/profiling.py) on
the CPU, as tests/test_profiling.py holds the JAX package's: StepTimer's
accounting, MetricsLogger's JSONL, device_memory_stats' shape, and a
trace written by trace() and by TrainPipeline's training.profile_dir."""

import json
import time

import torch

from vqvaehmm_tpu_torch.utils.profiling import (MetricsLogger, StepTimer,
                                                device_memory_stats, trace)


def test_step_timer_excludes_warmup_and_accounts_items():
    timer = StepTimer(warmup=2)
    for _ in range(5):
        with timer.step(items=10):
            time.sleep(0.01)
    s = timer.summary()
    assert s["steps"] == 3
    assert s["mean_step_s"] >= 0.01 and s["p50_step_s"] >= 0.01
    assert 0 < s["items_per_sec"] <= 3 * 10 / 0.03
    assert StepTimer(warmup=3).summary() == {"steps": 0}


def test_metrics_logger_appends_jsonl(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    log = MetricsLogger(path)
    log.log(1, loss=2.5)
    log.log(2, loss=1.25, lr=1e-3)
    log.close()
    log2 = MetricsLogger(path)          # append-only across a re-open
    log2.log(3, loss=0.5)
    log2.close()
    recs = [json.loads(line) for line in open(path)]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert recs[1]["loss"] == 1.25 and recs[1]["lr"] == 1e-3
    assert all("time" in r for r in recs)


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    assert isinstance(stats, dict) and len(stats) >= 1
    for v in stats.values():
        assert v is None or {"bytes_in_use", "peak_bytes_in_use",
                             "bytes_limit"} <= set(v)
    if not torch.cuda.is_available():
        assert stats == {"cpu": None}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as d:
        torch.ones(8, 8).matmul(torch.ones(8, 8)).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert d == str(tmp_path / "t")
    assert any("matmul" in e.get("name", "")
               for e in events["traceEvents"])
