"""The whole step's share of the card's float32 peak in the traced slice
(%): the operations the step's mathematics needs (counts.ops.step_ops, from
the work the traced inputs ask for) over the slice's wall time and
67 TFLOP/s (float32 outside the tensor cores: the program runs with TF32
off).  Nothing to read outside a train slice."""

from benchmark.counts import ops


def read(t):
    if t.kind != "train":
        return None
    ops_total = ops.step_ops(t.work(), t.model["crf"]["hidden"])
    return 100.0 * ops_total / (t.window_s * ops.FP32_FLOPS)
