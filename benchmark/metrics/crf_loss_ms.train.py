"""The CRF's and the loss's device time a training step (ms): kernel T1, the
blur average, the photometric and prior terms, from the end of the
program's mark composite to the start of its mark loss (benchmark.spans).
Nothing to read outside a train slice or without every step's marks."""

from benchmark import spans


def read(t):
    return spans.layer_ms(t, "train", "composite", "loss")
