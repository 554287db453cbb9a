"""A later change adds a cell, a traffic mix and a per-layer metric as new
files and new entries only; the harness finds them by name and runs
them, and no file the benchmark has changes."""

import json
import shutil
import time
from pathlib import Path

import torch

from conftest import SmallManifest
from portbench.harness import core

ROOT = Path(__file__).resolve().parents[2]
METRIC = '''"""score_requests_done: requests the measured window completed."""


def read(ctx):
    return float(ctx.window["units"]["request"])
'''


def _digest(root: Path):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_cell_mix_and_metric_added_as_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = _digest(tmp_path / "portbench")
    pb = tmp_path / "portbench"

    mix = json.loads((pb / "traffic" / "score-books.json").read_text())
    mix["panel"]["steps_max"] = 504
    (pb / "traffic" / "score-books-young.json").write_text(json.dumps(mix))
    (pb / "cells" / "f32.score-young.json").write_bytes(
        (pb / "cells" / "f32.score-books.json").read_bytes())
    (pb / "metrics" / "score_requests_done.py").write_text(METRIC)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "f32.score-young", "config": "vaehmm-f32",
        "traffic": "score-books-young", "chips": 1,
        "why": "books of listings one to two years old"})
    for m in bench["end_to_end"]:
        if "score_steps_per_s" == m["name"]:
            m["workloads"].append("f32.score-young")
    bench["per_layer"].append({
        "name": "score_requests_done", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "scoring request",
        "moves": "score_steps_per_s", "workloads": ["f32.score-young"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    m = SmallManifest(tmp_path)
    assert m.workload("f32.score-young")["traffic"] == "score-books-young"
    for trace in (0, 1):
        r = core.run(m, "f32.score-young", 5, 0.2, bool(trace),
                     torch.device("cpu"), time.perf_counter())
        assert all(c["value"] <= c["limit"] for c in r["checks"].values())
        if trace:
            assert r["metrics"]["score_requests_done"]["value"] > 0
        else:
            assert set(r["metrics"]) == {"score_steps_per_s", "setup_s"}
    after = _digest(pb)
    assert all(after[p] == b for p, b in before.items())
