"""optimizer_host_ms.train: host time of ClippedAdam.update's global-norm
clip and Adam step (`train.clip` and `train.adam` self time) over the
profiled slice, ms a step."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, ["train.clip", "train.adam"], "step")
