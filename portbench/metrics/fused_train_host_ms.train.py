"""fused_train_host_ms.train: host time of the training step's loss and
gradients call (`train.loss_grads` self time: kernel C's wrapper, or
the plain path, less any span inside it) over the profiled slice, ms a
step."""

from portbench.harness import program_spans


def read(ctx):
    return program_spans.self_ms(ctx, ["train.loss_grads"], "step")
