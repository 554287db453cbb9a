"""Each cell's control, the reference in the program's place computed one
precision step below the configuration's (its `control`), fails the
cell's comparison; at a tiny size on the CPU.  portbench/controls.py
reads the same at the cells' own sizes on the card."""

import pytest
import torch

from portbench.harness.core import Context
from portbench.harness.manifest import Manifest

CELLS = [w["name"] for w in Manifest().data["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison(small, cell):
    w = small.workload(cell)
    cfg = small.config(w["config"])
    traffic = small.traffic(w["traffic"])
    rules = small.cell(cell)
    failed = 0
    for seed in (1, 2, 3):
        ctx = Context(torch, torch.device("cpu"), seed, w, cfg, traffic,
                      rules, rules["control"])
        loop = small.loop(traffic).Loop(ctx)
        if loop.CHECKS_WINDOW:
            loop.window(0.2)
        loop.drop_program()
        checks = loop.check()
        failed += any(v > rules["limits"][n] for n, v in checks.items())
    assert failed == 3
