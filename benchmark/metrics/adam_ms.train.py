"""The optimizer's device time a training step (ms): Adam on every floating
leaf and the density-control statistics, from the end of the program's mark
backward to the start of its mark step_end (benchmark.spans).  Nothing to
read outside a train slice or without every step's marks."""

from benchmark import spans


def read(t):
    return spans.layer_ms(t, "train", "backward", "step_end")
