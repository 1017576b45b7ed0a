"""The compositor's device time a training step (ms): kernel B1 (dense: B3)
and the tile reassembly, from the end of the program's mark bin to the start
of its mark composite (benchmark.spans).  Nothing to read outside a train
slice or without every step's marks."""

from benchmark import spans


def read(t):
    return spans.layer_ms(t, "train", "bin", "composite")
