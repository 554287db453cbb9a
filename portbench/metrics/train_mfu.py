"""train_mfu: the useful operations of the measured window's training
steps (3 x the valid steps x a step's FLOPs, harness/counts.py) over the
window's wall time, as a share of the configuration's peak (%)."""


def read(ctx):
    w = ctx.window
    if not w.get("flops") or not w.get("seconds"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / ctx.peak()
