"""device_idle.train: the share of the profiled slice (%) in which no
operation ran on the device."""


def read(ctx):
    sl = ctx.slice
    if sl is None or sl.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.window_s)
