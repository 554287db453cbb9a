"""The saturated repeat-in-call marginal cost (counterpart of
vqvaehmm_tpu/utils/benchmarking.py), timed with CUDA events.

`make_repeat(R)` returns a callable that does the measured work R times
(a training step on the same batch, a request), queued on the card; the
marginal cost of one repeat is (t(2R) - t(R)) / R over the medians of
`trials` calls of each, which cancels what a call costs once (the first
launch's latency, the final synchronise).  R is sized so that a call
spends about `floor_ms` on the card.  A time is a CUDA event pair on the
current stream around the call, synchronised: it holds every host gap
between the call's launches too, so a host-bound loop reads its wall
time.  There is no CPU timer: the measurement needs a card, and without
one it raises.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

Timer = Callable[[Callable[[], object]], float]


def cuda_event_timer(fn: Callable[[], object]) -> float:
    """ms of one call of fn() on the current CUDA stream: an event before
    and after it, synchronised on the second."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("saturated_marginal times with CUDA events and "
                           "needs a CUDA device")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _measure_marginals(make_repeat, est_us: float, floor_ms: float,
                       windows: int, trials: int, timer: Optional[Timer]
                       ) -> Tuple[List[float], int]:
    """Size R, warm both repeat counts, and measure `windows` independent
    marginals (us a repeat) over the medians of `trials` calls each."""
    timer = timer or cuda_event_timer
    R = max(64, int(floor_ms * 1e3 / max(est_us, 1.0)))
    f1, f2 = make_repeat(R), make_repeat(2 * R)
    timer(f1)
    timer(f2)

    def med(f) -> float:
        return float(np.median([timer(f) for _ in range(trials)]))

    return [(med(f2) - med(f1)) / R * 1e3 for _ in range(windows)], R


def saturated_marginal(make_repeat: Callable[[int], Callable[[], object]],
                       est_us: float, floor_ms: float = 50.0,
                       trials: int = 7, timer: Optional[Timer] = None
                       ) -> Tuple[float, int]:
    """(microseconds a repeat, R).  est_us, a guess of one repeat's cost,
    sizes R; timer(fn) -> ms (cuda_event_timer unless given)."""
    margs, R = _measure_marginals(make_repeat, est_us, floor_ms, 1, trials,
                                  timer)
    return margs[0], R


def saturated_marginal_windows(make_repeat, est_us: float,
                               floor_ms: float = 50.0, windows: int = 5,
                               trials: int = 5,
                               timer: Optional[Timer] = None
                               ) -> Tuple[float, float, float, int]:
    """`windows` independent marginals: (median, minimum, maximum, R), in
    microseconds a repeat.  The median is the number to quote, the range
    its spread."""
    margs, R = _measure_marginals(make_repeat, est_us, floor_ms, windows,
                                  trials, timer)
    return (float(np.median(margs)), float(np.min(margs)),
            float(np.max(margs)), R)
