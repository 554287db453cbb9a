"""encode_host_ms.score: host time of the encoder, VAEHMM.encode (kernel
8's wrapper, or the plain stack; `model.encode` self time, wherever it
runs in a request) over the profiled slice, ms a request."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, ["model.encode"], "request")
