"""Binning and the stream gather's device time a training step (ms): packed,
the shared binning, the waterfill and G1's forward gather; dense, the
per-view sorts and tile lists; from the end of the program's mark project to
the start of its mark bin (benchmark.spans).  Nothing to read outside a
train slice or without every step's marks."""

from benchmark import spans


def read(t):
    return spans.layer_ms(t, "train", "project", "bin")
