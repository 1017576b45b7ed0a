"""Binning and the stream gather's device time a viewer request (ms): the
per-view sort, the waterfill and the gather (dense: the tile lists), from the
end of the program's mark project to the start of its mark bin
(benchmark.spans).  Nothing to read outside a serve slice or without every
request's marks."""

from benchmark import spans


def read(t):
    return spans.layer_ms(t, "serve", "project", "bin")
