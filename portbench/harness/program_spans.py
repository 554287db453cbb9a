"""The program's own host spans in a kept slice, for the per-layer metrics
that read them.

The program (`vqvaehmm_tpu_torch/utils/profiling.py`) records a span at a
layer's boundary while a torch.profiler profile is active, which the
slice is, on time.perf_counter(): the clock of the slice's `start` and
`end`, of the benchmark's `pb:` spans and of its marker-aligned kernel
events.  A program without those spans (`spans_between`) gives None, and
so does a slice in which it recorded none of the names asked for: the
metric is then left out of the result's line.

Units come from what the loop recorded of its calls (`slice.calls`): an
epoch is one entry of a training slice's `lengths`, a step one row of
it; a request is one of a scoring slice's `requests`."""

from __future__ import annotations

import importlib
from typing import Iterable, Optional

from .tracing import PROGRAM, Slice


def spans(sl: Optional[Slice]) -> Optional[list]:
    """The program's spans inside the slice, each with its `name`,
    `start`, `end`, `parent`, `root` and `self_s`; None where the slice or
    the program's recorder is missing."""
    if sl is None:
        return None
    try:
        mod = importlib.import_module(f"{PROGRAM}.utils.profiling")
    except ImportError:
        return None
    between = getattr(mod, "spans_between", None)
    if between is None:
        return None
    return between(sl.start, sl.end)


def units(sl: Slice, unit: str) -> int:
    c = sl.calls
    if unit == "epoch":
        return len(c["lengths"])
    if unit == "step":
        return sum(int(lengths.shape[0]) for lengths in c["lengths"])
    if unit == "request":
        return int(c["requests"])
    raise KeyError(unit)


def named(sl: Optional[Slice], names: Iterable[str]) -> Optional[list]:
    """The slice's program spans of these names; None where there are
    none."""
    got = spans(sl)
    if not got:
        return None
    names = set(names)
    picked = [s for s in got if s.name in names]
    return picked or None


def self_ms(ctx, names: Iterable[str], unit: str) -> Optional[float]:
    """Summed self time of the spans of these names, ms a unit."""
    picked = named(ctx.slice, names)
    if picked is None:
        return None
    return 1e3 * sum(s.self_s for s in picked) / units(ctx.slice, unit)


def total_ms(ctx, name: str, unit: str) -> Optional[float]:
    """Summed duration of the spans of this name, ms a unit."""
    picked = named(ctx.slice, [name])
    if picked is None:
        return None
    return 1e3 * sum(s.end - s.start for s in picked) \
        / units(ctx.slice, unit)


def idle_ms(ctx, name: str, unit: str) -> Optional[float]:
    """Device-idle time inside the spans of this name: each span's length
    less the device's busy time within it (the slice's idle gaps clipped
    to the span), ms a unit.  It is at most the spans' own time."""
    sl = ctx.slice
    picked = named(sl, [name])
    if picked is None:
        return None
    held = 0.0
    for s in picked:
        inside = [k for k in sl.kernels if k[1] < s.end and k[2] > s.start]
        held += (s.end - s.start) - Slice(inside, [], s.start,
                                          s.end).busy_s()
    return 1e3 * held / units(sl, unit)
