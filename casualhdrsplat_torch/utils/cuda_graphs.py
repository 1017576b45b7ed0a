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
replayed step counts the launches it really makes.  Other accounting that
Python does around a captured call (the collectives' [calls, bytes] on a
mesh) registers itself with `on_replay` while the graph captures, and runs
again on every replay.

Kernel nodes: at each capture a GraphedCall counts the kernel nodes of its
graph (`nodes`, the launches every replay makes, the trace's marks
included) and records them in `GRAPH_NODES` under the graph's name, the
latest capture last: a reader finds the training step's graph there by
its name ("the training step (SH degree d)").  A capture is the span
`chs.graph.capture` (utils/profiling.py), the graph's name its unit.

`AdamDescent` is the counterpart of the reference's `lax.scan` /
`fori_loop` Adam descents (the pose aligners, the CRF's gamma pre-fit):
one descent step captured over static tensors and replayed `steps` times,
with no host read between the steps.

On a CUDA device a capture that fails raises, naming the last ATen op
dispatched before the failure; nothing falls back to the eager function.
"""

from __future__ import annotations

import gc
import threading
from typing import Callable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from casualhdrsplat_torch.ops import cuda_build
from casualhdrsplat_torch.utils import profiling


def graphable(device, mesh=None) -> bool:
    """Whether calls on `device` replay CUDA graphs: on a CUDA device; on
    any other the eager functions run.  With a (data, gauss) mesh, only
    when every process group of it is NCCL: gloo runs its collectives on
    the host (the CPU worlds, and ranks sharing one card), which a graph
    cannot hold."""
    if torch.device(device).type != "cuda":
        return False
    return mesh is None or mesh.backends() == {"nccl"}


_side = threading.local()


def _side_stream() -> torch.cuda.Stream:
    """This thread's side stream on the current device, for all its
    warm-ups and captures.  PyTorch keeps a cuBLAS workspace (32 MiB on an
    H100) for every stream a matmul ran on, for the life of the process: a
    new stream for each warm-up and capture left one behind each time."""
    streams = _side.__dict__.setdefault("streams", {})
    device = torch.cuda.current_device()
    if device not in streams:
        streams[device] = torch.cuda.Stream()
    return streams[device]


# the GraphedCall capturing on each stream, by the stream's handle: the
# backward of a captured step runs in autograd's own thread, on the stream
# of its forward (`on_replay`)
_capturing: dict = {}
# the kernel nodes of each graph's latest capture, by the graph's name, the
# latest capture last
GRAPH_NODES: dict = {}


def on_replay(fn: Callable[[], None]) -> bool:
    """While the current stream is captured by a GraphedCall: have `fn()`
    run after every replay of that graph (the accounting a replay runs no
    Python for) and return True.  Otherwise return False: nothing is
    captured, and the caller does its accounting now."""
    if not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()):
        return False
    call = _capturing.get(torch.cuda.current_stream().cuda_stream)
    if call is None:
        return False
    call._pending.append(fn)
    return True


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
        self.nodes = 0  # kernel nodes of the captured graph
        # each counter's launches per replay
        self._rise: list = []
        # what `on_replay` registered during the capture
        self._after_replay: list = []
        self._pending: list = []

    def __call__(self):
        if self.graph is None:
            if not self.warmed:
                return self._warm_up()
            with profiling.span("graph.capture", self.name):
                self._capture()
        self.graph.replay()
        self.replays += 1
        for counter, rise in self._rise:
            counter.launches += rise
        for fn in self._after_replay:
            fn()
        return self.outputs

    def _warm_up(self):
        side = _side_stream()
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
        stream = _side_stream()  # `on_replay` finds this capture by its stream
        self._pending = []
        _capturing[stream.cuda_stream] = self
        # A graph destroyed while this one captures invalidates the capture,
        # and a collection of garbage may destroy one (a graph in a
        # reference cycle): none runs until the capture ends.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode=self.capture_error_mode):
                with tracker:
                    outputs = self.fn()
                nodes = profiling.kernel_nodes(stream)
        except Exception as exc:
            for c, b in zip(counters, before):
                c.launches = b
            raise RuntimeError(
                f"CUDA graph capture of {self.name} failed; the last ATen op dispatched was "
                f"{tracker.last}: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
            del _capturing[stream.cuda_stream]
        self._after_replay, self._pending = self._pending, []
        self._rise = [(c, c.launches - b) for c, b in zip(counters, before)
                      if c.launches != b]
        for c, b in zip(counters, before):  # the capture launched nothing
            c.launches = b
        self.graph, self.outputs, self.nodes = graph, outputs, nodes
        self.captures += 1
        GRAPH_NODES.pop(self.name, None)
        GRAPH_NODES[self.name] = nodes


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


_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def adam_update(x, mu, nu, grad, count, lr: float):
    """optax.adam's update (b1 0.9, b2 0.999, eps 1e-8) at the step count
    `count` (a device tensor, 1 for the first update): the new (x, mu, nu).
    The bias corrections 1 - b ** count are evaluated in float32 as optax
    does, where 1 - 0.999 is 1.3e-5 off the exact value: in Python floats
    the first update moves x 7e-6 of lr further than optax's, enough for a
    short descent on a steep loss to part from the reference's."""
    mu = _B1 * mu + (1.0 - _B1) * grad
    nu = _B2 * nu + (1.0 - _B2) * (grad * grad)
    t = count.to(torch.float32)
    mu_hat = mu / (1.0 - torch.pow(_B1, t))
    nu_hat = nu / (1.0 - torch.pow(_B2, t))
    return x + mu_hat / (torch.sqrt(nu_hat) + _EPS) * -lr, mu, nu


class AdamDescent:
    """`steps` Adam updates (`adam_update` at `lr`) of one tensor x from
    x0, minimising `loss_fn(x)`: the reference's `lax.scan` / `fori_loop`
    descent.  x, Adam's moments, the step count and the loss curve
    [steps] (the loss before each update) are device tensors this object
    keeps; one step (the loss, `torch.autograd.grad`, the update, the loss
    written into the curve at the count) reads only them and the static
    tensors `loss_fn` reads, and writes only them.

    With `graphed` on a CUDA device the step is a GraphedCall: the first
    step of the object's first descent is the eager warm-up, the second
    captures and replays, every later step (of this descent and of the
    next ones) replays; each of them is one real step.  Otherwise the
    step runs eagerly.  Nothing reads the host between the steps: a call
    returns copies of x and of the curve."""

    def __init__(self, loss_fn: Callable[[torch.Tensor], torch.Tensor], like: torch.Tensor,
                 steps: int, lr: float, name: str, graphed: bool = True):
        self.loss_fn, self.steps, self.lr = loss_fn, steps, lr
        with torch.inference_mode(False):  # written again outside a caller's mode
            self.x = torch.zeros_like(like, dtype=torch.float32)
            self.mu, self.nu = torch.zeros_like(self.x), torch.zeros_like(self.x)
            self.count = torch.zeros((), dtype=torch.int32, device=like.device)
            self.curve = torch.zeros(steps, dtype=torch.float32, device=like.device)
        self.step = (GraphedCall(self._step, name) if graphed and graphable(like.device)
                     else self._step)

    def _step(self) -> None:
        x = self.x.detach().requires_grad_(True)
        val = self.loss_fn(x)
        grad, = torch.autograd.grad(val, x)
        with torch.no_grad():
            self.count += 1
            x_new, mu, nu = adam_update(self.x, self.mu, self.nu, grad, self.count, self.lr)
            self.x.copy_(x_new)
            self.mu.copy_(mu)
            self.nu.copy_(nu)
            self.curve.index_copy_(0, (self.count - 1).long().reshape(1),
                                   val.detach().reshape(1))

    def __call__(self, x0: torch.Tensor):
        """(x after `steps` updates from x0, the loss curve [steps])."""
        with torch.inference_mode(False), torch.enable_grad():
            with torch.no_grad():
                self.x.copy_(x0)
                self.mu.zero_()
                self.nu.zero_()
                self.count.zero_()
            for _ in range(self.steps):
                self.step()
        return self.x.clone(), self.curve.clone()
