"""Kernel B2, the packed compositor's backward
(csrc/rasterize_packed_bwd.cu), share of its roofline in the traced slice (%):
the least time its work needs (counts.ops.b2: the larger of operations
over the float32 peak and bytes over the HBM bandwidth) over the device
time of its launches, found by kernel name.  Nothing to read where the
kernel did not run or the slice is not train."""

from benchmark.counts import ops

KERNELS = ("rasterize_packed_bwd_kernel",)


def read(t):
    seconds = t.kernel_seconds(KERNELS)
    if t.kind != "train" or seconds <= 0:
        return None
    return 100.0 * ops.roofline_seconds(*ops.b2(t.work())) / seconds
