"""viterbi_host_ms.score: host time of the Viterbi decode's call,
ops/fused_viterbi.py viterbi_fused (kernel B's wrapper; `hmm.viterbi`
self time) over the profiled slice, ms a request."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, ["hmm.viterbi"], "request")
