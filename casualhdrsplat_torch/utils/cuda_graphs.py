"""CUDA graphs: the counterpart of the JAX package's compiled programs.

The reference dispatches its training step (`Trainer._train_step`,
`jax.jit`), its renders and bench.py's step each as one compiled program.
The port runs them eagerly, one launch per PyTorch op, and on an H100 the
host then sets the pace: thousands of launches a step.  `GraphedCall`
replays such a function as one captured CUDA graph instead.

- warm-up: the first call runs the function eagerly on a side stream
  (lazy initialisation: kernel builds, Triton compiles, library handles);
  its result is returned, so it is a real call;
- capture: the second call records the function into a CUDA graph with
  its own memory pool, then replays it;
- every later call replays the graph.

The function reads its inputs from static tensors that the caller fills
before each call (a device buffer for every number that changes from call
to call: a Python number would be frozen into the graph) and returns
tensors the graph owns, which the next replay overwrites: a caller copies
out what it keeps.  The tensors the graph reads must stay where they were
at capture: `GraphCache.get` compares them by identity before each replay,
and a call whose tensors or static key changed captures again.

Launch counters (ops/cuda_build.COUNTERS): a kernel's wrapper counts in
Python, and a replay runs no Python.  So the rise of every counter during
capture is taken back (nothing ran) and added again on every replay: a
replayed step counts the launches it really makes.

On a CUDA device a capture that fails raises, naming the last ATen op
dispatched before the failure; nothing falls back to the eager function.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from casualhdrsplat_torch.ops import cuda_build


def graphable(device) -> bool:
    """Whether calls on `device` replay CUDA graphs: on a CUDA device; on
    any other the eager functions run."""
    return torch.device(device).type == "cuda"


class _LastOp(TorchDispatchMode):
    """Remembers the last ATen op dispatched (only while capturing)."""

    def __init__(self):
        super().__init__()
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = func
        return func(*args, **(kwargs or {}))


class GraphedCall:
    """`fn()` replayed as one captured CUDA graph after one eager warm-up
    call; see the module's docstring.  `name` names the graph in errors.
    `capture_error_mode` is torch.cuda.graph's: "thread_local" lets other
    threads use the card while this one captures (a server's renders)."""

    def __init__(self, fn: Callable[[], object], name: str, capture_error_mode="global"):
        self.fn = fn
        self.name = name
        self.capture_error_mode = capture_error_mode
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.outputs = None
        self.warmed = False
        self.captures = 0
        self.replays = 0
        # each counter's launches per replay
        self._rise: list = []

    def __call__(self):
        if self.graph is None:
            if not self.warmed:
                return self._warm_up()
            self._capture()
        self.graph.replay()
        self.replays += 1
        for counter, rise in self._rise:
            counter.launches += rise
        return self.outputs

    def _warm_up(self):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = self.fn()
        torch.cuda.current_stream().wait_stream(side)
        self.warmed = True
        return out

    def _capture(self) -> None:
        counters = list(cuda_build.COUNTERS)
        before = [c.launches for c in counters]
        graph = torch.cuda.CUDAGraph()
        tracker = _LastOp()
        try:
            with torch.cuda.graph(graph, capture_error_mode=self.capture_error_mode):
                with tracker:
                    outputs = self.fn()
        except Exception as exc:
            for c, b in zip(counters, before):
                c.launches = b
            raise RuntimeError(
                f"CUDA graph capture of {self.name} failed; the last ATen op dispatched was "
                f"{tracker.last}: {exc}") from exc
        self._rise = [(c, c.launches - b) for c, b in zip(counters, before)
                      if c.launches != b]
        for c, b in zip(counters, before):  # the capture launched nothing
            c.launches = b
        self.graph, self.outputs = graph, outputs
        self.captures += 1


class GraphCache:
    """The graphs of one caller, by static key, each valid while the
    tensors it reads are the ones it was captured with.  Keeps the graph
    of the latest key only: a training run's keys (SH degree, say) change
    in one direction, and each graph holds its own memory pool."""

    def __init__(self):
        self.key = None
        self.inputs: Sequence[torch.Tensor] = ()
        self.call: Optional[GraphedCall] = None

    def get(self, key, inputs: Sequence[torch.Tensor], make: Callable[[], GraphedCall]):
        """The graphed call for `key` over `inputs`, made anew (to warm up
        and capture) when either changed since the last call."""
        if (self.call is None or key != self.key or len(inputs) != len(self.inputs)
                or any(a is not b for a, b in zip(inputs, self.inputs))):
            self.call = None  # releases the old graph's pool
            self.key, self.inputs = key, tuple(inputs)
            self.call = make()
        return self.call
