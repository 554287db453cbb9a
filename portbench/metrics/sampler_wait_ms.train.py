"""sampler_wait_ms.train: device-idle time of the profiled slice inside
the `sampler.draw` spans (the card waiting on the host's draw of the
next epoch; each idle gap clipped to the draw), ms an epoch."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, "sampler.draw", "epoch")
