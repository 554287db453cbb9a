"""fused_train_roofline: kernel C's share of its roofline (%), over the
profiled slice: the least time its steps need (harness/counts.py
train_work from each step's lengths, at the configuration's peak) over
the device time of the kernels the route lists for it."""

from portbench.harness import counts
from portbench.reference.vaehmm import dims_of

COUNTER = "ops.fused_train:fused_loss_and_grads.launches"


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    device_s = sl.kernel_s(ctx.kernels(COUNTER))
    if device_s <= 0.0:
        return None
    d, B = dims_of(ctx.config["model"]), sl.calls["B"]
    least = 0.0
    for lengths in sl.calls["lengths"]:
        for steps in lengths.long().sum(dim=1).tolist():
            least += counts.bound_s(*counts.train_work(d, B, steps),
                                    ctx.peak())[0]
    return 100.0 * least / device_s
