"""Every cell on the card, briefly, one process a run as the benchmark's
command runs: correct, on its route, and its traced run reads every
per-layer metric it lists.  Needs an NVIDIA GPU: `python -m pytest
portbench/tests/test_portbench_card.py -m cuda` on the card's machine;
skipped elsewhere."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness.manifest import Manifest

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in Manifest().data["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "4242", "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], (r, out.stderr[-3000:])
    m = Manifest()
    want = m.per_layer(cell) if trace else m.end_to_end(cell)
    assert set(r["metrics"]) == {x["name"] for x in want}
    assert r["device"]["platform"] == "gpu"
