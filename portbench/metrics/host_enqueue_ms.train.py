"""host_enqueue_ms.train: host time of the epoch call before its loss is
fetched, over its steps (ms a step), in the measured window."""


def read(ctx):
    w = ctx.window
    return 1e3 * w["host"]["enqueue_s"] / w["units"]["step"]
