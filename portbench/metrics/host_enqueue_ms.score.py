"""host_enqueue_ms.score: host time to issue a request (the posterior and
the Viterbi decode called, before the synchronise), ms a request, in
the measured window."""


def read(ctx):
    w = ctx.window
    return 1e3 * w["host"]["issue_s"] / w["units"]["request"]
