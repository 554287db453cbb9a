"""BENCHMARK.json and the files it names.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by its name:

* `configs/<config>.json` (the `file` of the configuration's entry): the
  model as it is run, its published training settings and its peak;
* `traffic/<mix>.json`: the mix's parameters and `loop`, the name of the
  general loop that reads them (`loops/<loop>.py`);
* `cells/<cell>.json`: the route the cell must take (which of the
  program's launch counters move, by how much a unit, and the CUDA
  kernels each counted call launches) and the limits of its comparison;
* `metrics/<metric>.py`: the reader of a per-layer metric, `read(ctx)`.

A later change adds a cell, a mix, a configuration or a metric by adding
such files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[2]


class Manifest:
    """BENCHMARK.json at `root` and the benchmark's files under
    `root/portbench`."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self._modules: Dict[str, ModuleType] = {}

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def cell(self, name: str) -> dict:
        return json.loads((self.dir / "cells" / f"{name}.json").read_text())

    def _load(self, kind: str, name: str) -> ModuleType:
        key = f"{kind}/{name}"
        if key not in self._modules:
            path = self.dir / kind / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{name.replace('.', '_')}", path)
            if spec is None:
                raise FileNotFoundError(path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def loop(self, traffic: dict) -> ModuleType:
        return self._load("loops", traffic["loop"])

    def reader(self, metric: str) -> ModuleType:
        return self._load("metrics", metric)

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics a cell reports."""
        return [m for m in self.data["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics a cell's traced run reports: those that
        list it, and those without a list that move an end-to-end metric
        the cell reports."""
        moves = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moves)]
