"""optimizer_ms.train: device time a step (ms) of every operation in the
profiled slice that is neither kernel C nor kernel D: the global-norm
clip, Adam, the loss's running sum and the triples' copies."""

C = "ops.fused_train:fused_loss_and_grads.launches"
D = "ops.gather:gather_epoch.launches"


def read(ctx):
    sl = ctx.slice
    if sl is None:
        return None
    steps = sum(int(lengths.shape[0]) for lengths in sl.calls["lengths"])
    every = sum(b - a for _, a, b in sl.kernels)
    rest = every - sl.kernel_s(ctx.kernels(C) + ctx.kernels(D))
    return 1e3 * rest / steps
