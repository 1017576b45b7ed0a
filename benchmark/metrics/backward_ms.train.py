"""The backward's device time a training step (ms): all of
`torch.autograd.grad` (B2 or B4, G1, T1's backward and the plain layers'
gradients), from the end of the program's mark loss to the start of its
mark backward (benchmark.spans).  Nothing to read outside a train slice or
without every step's marks."""

from benchmark import spans


def read(t):
    return spans.layer_ms(t, "train", "loss", "backward")
