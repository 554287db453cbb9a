"""sampler_ms.train: host time of the device sampler's draw of an epoch's
triples (`sampler.draw` spans: the draws, their check and their three
blocking uploads), summed over the profiled slice's epochs, ms an
epoch."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.total_ms(ctx, "sampler.draw", "epoch")
