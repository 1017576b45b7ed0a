"""The projection's device time a training step (ms): spline poses,
activation, SH and projection up to the payload rows, from the end of the
program's mark step_begin to the start of its mark project (benchmark.spans).
Nothing to read outside a train slice or without every step's marks."""

from benchmark import spans


def read(t):
    return spans.layer_ms(t, "train", "step_begin", "project")
