"""evidence_host_ms.score: host time of the HMM's evidence,
VAEHMM._evidence_inputs (kernel 11's wrapper, or the plain prior and
log-softmax; `model.evidence` self time, the plain encoder's own span
left out) over the profiled slice, ms a request."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, ["model.evidence"], "request")
