"""The program's launch counters, the route a cell must take, and the
profiled slice that per-layer metrics divide by.

A counter is named `<module>:<attribute path>` under the program's
package, e.g. `ops.fused_train:fused_loss_and_grads.launches`.  A cell's
route (`cells/<cell>.json`) lists counters, how much each moves a unit
of the loop ("per": a unit name, "none" for not at all, "any" for only
the trace's check), and the CUDA kernels each counted call launches once.

A slice is profiled with torch.profiler (the card's kernels), the
benchmark's own host spans (`pb:*`) taken beside it.  The
profiler has been seen to drop kernel events late in a run, so a slice
is kept only where it holds, of every route kernel, as many events as
its counter moved; otherwise it is taken again, up to three times, and
never divided."""

from __future__ import annotations

import importlib
import re
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

PROGRAM = "vqvaehmm_tpu_torch"
SPAN = "pb:"
ATTEMPTS = 3


def read_counter(spec: str) -> int:
    module, path = spec.split(":")
    obj = importlib.import_module(f"{PROGRAM}.{module}")
    for part in path.split("."):
        obj = getattr(obj, part)
    return int(obj)


def read_counters(route: List[dict]) -> Dict[str, int]:
    return {r["counter"]: read_counter(r["counter"]) for r in route}


def route_faults(route: List[dict], moved: Dict[str, int],
                 units: Dict[str, int]) -> List[str]:
    """Where the counters moved otherwise than the route says over
    `units` (unit name -> how many the loop ran)."""
    out = []
    for r in route:
        per, got = r["per"], moved[r["counter"]]
        if per == "any":
            continue
        want = 0 if per == "none" else units[per]
        if got != want:
            out.append(f"{r['counter']} moved {got}, the route wants "
                       f"{want} ({per})")
    return out


def _pattern(kernel: str):
    return re.compile(r"(?<![A-Za-z0-9_])" + re.escape(kernel)
                      + r"(?![A-Za-z0-9_])")


def short_name(name: str) -> str:
    """A kernel event's function name without its return type, namespace
    and arguments."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""),
                    maxsplit=1)[0].strip()
    return head.split()[-1].split("::")[-1] if head else name


@dataclass
class Slice:
    """A checked profile: kernels (name, start s, end s), the benchmark's
    host spans (name, start s, end s), the slice's own span, and what the
    loop recorded about the calls it made in it."""
    kernels: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    start: float
    end: float
    calls: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self) -> float:
        busy, reach = 0.0, self.start
        for a, b in sorted((max(a, self.start), min(b, self.end))
                           for _, a, b in self.kernels):
            if b > reach:
                busy += b - max(a, reach)
                reach = b
        return busy

    def kernel_s(self, names) -> float:
        """Summed device time of the kernels of these names."""
        pats = [_pattern(n) for n in names]
        return sum(b - a for n, a, b in self.kernels
                   if any(p.search(n) for p in pats))

    def count(self, kernel: str) -> int:
        p = _pattern(kernel)
        return sum(1 for n, _, _ in self.kernels if p.search(n))

    def device_ops(self, top: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for n, a, b in self.kernels:
            k = short_name(n)
            total[k] = total.get(k, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle device time by the host span it fell under (the innermost
        `pb:` span at the gap's middle; "host:other" outside them)."""
        gaps, reach = [], self.start
        for a, b in sorted((max(a, self.start), min(b, self.end))
                           for _, a, b in self.kernels):
            if a > reach:
                gaps.append((reach, a))
            reach = max(reach, b)
        if reach < self.end:
            gaps.append((reach, self.end))
        total: Dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inside = [(s1 - s0, n) for n, s0, s1 in self.spans
                      if s0 <= mid <= s1]
            name = min(inside)[1] if inside else "host:other"
            total[name] = total.get(name, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:top]]


def profile(torch, run: Callable, route: List[dict],
            device) -> Tuple[Optional[Slice], List[str]]:
    """Profile run(span), which runs the slice, wraps its host phases in
    span(name) and returns what it records of its calls; check its kernel
    events against the counters, retake a slice that lost events.  (slice
    or None, what each failed attempt lacked).

    Only the card's activity is traced: tracing the host's operators too
    slowed the host's enqueue of a training step some threefold, and so
    the device's idle share.  The host spans are read from the host's
    clock.  The trace's kernels are placed on it by a marker, a one-value
    fill launched on the idle card as the slice opens (its start lies
    some microseconds after the host's reading): the runtime events of
    the trace were seen 0.3-2 ms off the kernels' clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    from .device import sync

    on_card = device.type == "cuda"
    lost = []
    for attempt in range(1, ATTEMPTS + 1):
        spans: List[Tuple[str, float, float]] = []

        @contextmanager
        def span(name: str):
            a = time.perf_counter()
            yield
            spans.append((SPAN + name, a, time.perf_counter()))

        before = read_counters(route)
        sync(torch, device)
        with tprofile(activities=[ProfilerActivity.CUDA if on_card
                                  else ProfilerActivity.CPU]) as prof:
            sync(torch, device)
            start = time.perf_counter()
            if on_card:
                torch.zeros(1, device=device)
            calls = run(span)
            sync(torch, device)
            end = time.perf_counter()
        moved = {k: read_counter(k) - v for k, v in before.items()}
        kernels = sorted(
            ((e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
             for e in prof.events() if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)),
            key=lambda k: k[1])
        short = []
        if on_card:
            if kernels and "Fill" in kernels[0][0]:
                shift = start - kernels[0][1]
                kernels = [(n, a + shift, b + shift)
                           for n, a, b in kernels[1:]]
            else:
                short.append(f"attempt {attempt}: no marker opens the "
                             "trace")
        sl = Slice(kernels, spans, start, end, calls)
        for r in route:
            for k in r.get("kernels", []):
                if sl.count(k) != moved[r["counter"]]:
                    short.append(f"attempt {attempt}: {sl.count(k)} events "
                                 f"of {k}, its counter moved "
                                 f"{moved[r['counter']]}")
        if not short:
            return sl, lost
        lost.extend(short)
        time.sleep(0.5)
    return None, lost
