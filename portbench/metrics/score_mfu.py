"""score_mfu: the operations the measured window's requests need (the
posterior's encoder over the padded steps, the evidence and the Viterbi
scan over the valid ones, harness/counts.py) over the window's wall
time, as a share of the configuration's peak (%)."""


def read(ctx):
    w = ctx.window
    if not w.get("flops") or not w.get("seconds"):
        return None
    return 100.0 * w["flops"] / w["seconds"] / ctx.peak()
