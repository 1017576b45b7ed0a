"""The port's tracing: host spans and device marks at the layer boundaries,
all on the clock of torch.profiler's trace, and the operator's exporter.

- `span(name, unit)`: while a torch.profiler records, a range named
  `chs.<name>` on the host, with the unit it belongs to (the step number,
  the request's ordinal; the graph's name for a capture; the source for a
  build) as its `unit` argument, which the trace shows where the profiler
  records shapes (`trace` does), so the spans of one unit share it.
  Otherwise one shared no-op context: one check, nothing allocated.  A
  span goes only where the host runs at every call: inside the body of a
  captured CUDA graph it would run at the capture and never at a replay.
- `mark(boundary, like)`: on a CUDA tensor's device, an empty kernel named
  `chs_mark_<boundary>` (csrc/trace_mark.cu) launched on the current
  stream.  Inside a captured graph it is a node of the graph, so every
  replay runs it, and the profiler's device trace names it on the device
  clock between the work before and after the boundary.  It does no work
  and is counted by no launch counter; off CUDA it does nothing.
- `kernel_nodes(stream)`: the kernel nodes of the graph `stream` is
  capturing into (utils/cuda_graphs.py records it at every capture).
- `trace(log_dir)`: torch.profiler over the block, host and card, written
  as a Chrome trace (Perfetto, chrome://tracing) in which the spans and the
  marks stand beside the card's kernels.

The boundaries, in the order a unit reaches them:

    training step: step_begin, project, bin, composite, loss, backward, step_end
    render_pose:   render_begin, project, bin, composite, render_end

`project` follows the spline poses, activation, SH and projection up to
the payload rows; `bin` the binning and the stream gather (dense: the
tile lists); `composite` the compositor and the tile reassembly; `loss` the
CRF, the blur average and the loss terms (the start of the backward);
`backward` the end of `torch.autograd.grad`; `step_end` Adam and the
density statistics.
"""

from __future__ import annotations

import contextlib
import ctypes
import os

import torch

from casualhdrsplat_torch.ops import cuda_build

# the boundaries, in csrc/trace_mark.cu's order (its `which`)
MARKS = ("step_begin", "project", "bin", "composite", "loss", "backward", "step_end",
         "render_begin", "render_end")
_WHICH = {name: i for i, name in enumerate(MARKS)}
_MARK = cuda_build.CudaKernel("trace_mark.cu", "chs_trace_mark",
                              [ctypes.c_int, ctypes.c_void_p], counted=False)
_NODES = cuda_build.CudaKernel("trace_mark.cu", "chs_capture_kernel_nodes",
                               [ctypes.c_void_p, ctypes.c_void_p], counted=False)
_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch.profiler records in this process."""
    return torch._C._autograd._profiler_enabled()


def span(name: str, unit=None):
    """`chs.<name>` on the host while a profiler records, carrying `unit`
    (an int or a str); otherwise a shared no-op context.  torch's Chrome
    exporter drops a `record_function`'s arguments, so the range is
    torch's `_RecordFunctionFast` (an operator event, `cpu_op`), whose
    keyword arguments it exports; that call aborts the process on
    arguments of another type, so they are always a list and a dict."""
    if not recording():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(
        "chs." + name, [], {} if unit is None else {"unit": unit})


def mark(boundary: str, like: torch.Tensor) -> None:
    """The device mark `chs_mark_<boundary>` on the stream of `like`'s
    device, where that is a CUDA device; elsewhere it only checks the name."""
    which = _WHICH[boundary]
    if like.is_cuda:
        _MARK(which, torch.cuda.current_stream(like.device).cuda_stream)


def kernel_nodes(stream: torch.cuda.Stream) -> int:
    """The kernel nodes of the CUDA graph `stream` is capturing into."""
    out = ctypes.c_longlong(0)
    _NODES(stream.cuda_stream, ctypes.addressof(out))
    return out.value


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (host and, where there is one, the
    card), written as a Chrome trace into `log_dir`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
