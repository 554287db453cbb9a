"""One run of a cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result's line.

The loop of a cell's traffic (`loops/<loop>.py`) owns what is particular
to it: `Loop(ctx)` makes the data and weights from the seed, builds the
program's objects and warms the cell's shapes (set-up);
`loop.window(seconds)` measures and returns the end-to-end metrics, the
units it ran and its host spans; `loop.slice()` runs a short steady
slice for the profiler and returns what it recorded of its calls;
`loop.drop_program()` frees the program's state; `loop.check()` returns
the numbers compared, each beside its limit."""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import device as dev_mod
from . import guard, tracing
from .manifest import Manifest


@dataclass
class Context:
    """What a loop and a metric reader see."""
    torch: object
    device: object
    seed: int
    cell: dict
    config: dict
    traffic: dict
    rules: dict
    control: Optional[str] = None      # a rounding in the program's place
    window: dict = field(default_factory=dict)
    slice: Optional[tracing.Slice] = None
    marks: List[tuple] = field(default_factory=list)

    def mark(self, phase: str) -> None:
        """The end of a phase of set-up, on the host's clock."""
        self.marks.append((phase, time.perf_counter()))

    def kernels(self, counter: str) -> List[str]:
        """The CUDA kernels the route lists under a counter."""
        for r in self.rules["route"]:
            if r["counter"] == counter:
                return r.get("kernels", [])
        return []

    def peak(self) -> float:
        """The configuration's peak FLOP/s."""
        return dev_mod.PEAK_FLOPS[self.config["peak"]]


def run(manifest: Manifest, workload: str, seed: int, seconds: float,
        trace: bool, device, t0: float, stderr=None) -> dict:
    """The result of one run (the dict printed as the last line), after
    printing the compared numbers as the last lines of `stderr` (standard
    error by default)."""
    import torch

    stderr = stderr or sys.stderr
    cell = manifest.workload(workload)
    traffic = manifest.traffic(cell["traffic"])
    ctx = Context(torch, device, seed, cell, manifest.config(cell["config"]),
                  traffic, manifest.cell(workload))
    ctx.mark("torch")
    loop = manifest.loop(traffic).Loop(ctx)
    route = ctx.rules["route"]
    before = tracing.read_counters(route)
    setup_s = time.perf_counter() - t0

    window = loop.window(seconds)
    ctx.window = window
    moved = {k: tracing.read_counter(k) - v for k, v in before.items()}
    faults = tracing.route_faults(route, moved, window["units"])
    metrics: Dict[str, dict] = {}
    breakdown = None
    if trace:
        ctx.slice, lost = tracing.profile(torch, loop.slice, route, device)
        for line in lost:
            print(f"portbench: trace {line}", file=stderr)
        if ctx.slice is None:
            faults.append(f"every profiled slice lost kernel events "
                          f"({len(lost)} shortfalls)")
        else:
            breakdown = {"device_ops": ctx.slice.device_ops(),
                         "idle_gaps": ctx.slice.idle_gaps()}
        for m in manifest.per_layer(workload):
            value = manifest.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in manifest.end_to_end(workload):
            value = setup_s if m["name"] == "setup_s" \
                else window["metrics"].get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    info = dev_mod.describe(torch, device, cell["chips"])
    if trace and ctx.slice is not None:
        info["busy_s"] = ctx.slice.busy_s()
        info["window_s"] = ctx.slice.window_s
    loop.drop_program()
    checks = loop.check()
    limits = ctx.rules["limits"]
    compared = {name: {"value": value, "limit": limits[name]}
                for name, value in checks.items()}
    correct = not faults and all(c["value"] <= c["limit"]
                                 for c in compared.values())
    if device.type == "cuda":
        power = dev_mod.power_limit()
        if power:
            info["power_limit"] = power
        print(f"portbench: peaks {dev_mod.PEAK_FLOPS} FLOP/s, "
              f"{dev_mod.PEAK_BYTES} B/s ({dev_mod.PEAK_SOURCE}); card "
              f"{power}", file=stderr)
    print("portbench: set-up " + ", ".join(
        f"{phase} {at - t0:.3f} s" for phase, at in ctx.marks), file=stderr)
    for line in faults:
        print(f"portbench: route {line}", file=stderr)
    for name, c in compared.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=stderr)
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": metrics,
              "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if faults:
        result["route_faults"] = faults
    result["checks"] = compared
    return result


def main(argv: List[str], t0: float) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="portbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    manifest = Manifest()
    cell = manifest.workload(args.workload)
    dev_mod.use_checkout_caches(manifest.root)
    import torch

    dev_mod.require_chips(torch, cell["chips"])
    torch.set_num_threads(1)
    result = run(manifest, args.workload, args.seed, args.seconds,
                 bool(args.trace), torch.device("cuda", 0), t0)
    found = guard.loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
