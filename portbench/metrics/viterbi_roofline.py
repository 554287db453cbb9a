"""viterbi_roofline: kernel B's share of its roofline (%) over the
profiled slice: the least time the scan needs over a book's valid steps
(harness/counts.py viterbi_work; it is bound by bytes), a request, over
the device time of the kernels the route lists for it."""

from portbench.harness import counts
from portbench.reference.vaehmm import dims_of

COUNTER = "ops.fused_viterbi:viterbi_fused.launches"


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    device_s = sl.kernel_s(ctx.kernels(COUNTER))
    if device_s <= 0.0:
        return None
    c = sl.calls
    least = counts.bound_s(*counts.viterbi_work(
        dims_of(ctx.config["model"]), c["assets"], c["steps"]),
        ctx.peak())[0]
    return 100.0 * c["requests"] * least / device_s
