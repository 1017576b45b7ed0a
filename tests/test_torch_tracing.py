"""The port's tracing (utils/profiling.py): host spans, device marks and the
kernel nodes of a captured graph.

On the CPU: `span` is a `chs.*` range carrying its unit under the
profiler and one shared no-op context without one; a `Trainer.run_step`
and a viewer request (`make_orbit_render_fn`) leave their documented spans,
nested in their unit's span and in order; a build that runs nvcc is the
span `chs.kernel.build` and a library already built is none; the marks are
no-ops off CUDA, and the training step (both rasterizer paths, on one
device and on a mesh of one) and `render_pose` (its three modes) reach
their boundaries in the documented order (a stand-in for `mark` records
the calls).

On the card (marked `cuda`, skipped here; `python -m pytest
tests/test_torch_tracing.py -m cuda`): the marks build and launch without
moving a launch counter; a replayed step and a replayed render show their
marks in the device trace in order; `GraphedCall` keeps its `captures` /
`replays` meaning, its capture is the span `chs.graph.capture` and it
records its kernel nodes in `GRAPH_NODES`; and a captured step's `nodes`
equals the kernels that the profiler sees a replay of it run on the card.
"""

import json
import subprocess

import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.models import image_formation as imf
from casualhdrsplat_torch.ops import cuda_build
from casualhdrsplat_torch.train.trainer import Trainer
from casualhdrsplat_torch.utils import cuda_graphs, profiling
from casualhdrsplat_torch.viewer.server import make_orbit_render_fn
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

STEP = ["step_begin", "project", "bin", "composite", "loss", "backward", "step_end"]
RENDER = ["render_begin", "project", "bin", "composite", "render_end"]


def _cfg(packed: bool = True, densify: bool = False):
    cfg = t_config.TrainConfig()
    cfg.model = t_config.ModelConfig(
        max_gaussians=128, sh_degree=1, num_virtual_views=2, crf=t_config.CRFConfig(hidden=8),
        rasterize=t_config.RasterizeConfig(tile_h=8, tile_w=16, chunk=32, packed=packed,
                                           tile_capacity=64, stream_factor=8))
    cfg.densify.enabled = densify
    cfg.densify.start_iter = cfg.densify.interval = 2  # a round after the second step
    cfg.data.eval_every = 0
    return cfg


def _trainer(device="cpu", packed: bool = True, densify: bool = False, mesh=None):
    ds = t_dataset.make_synthetic_dataset(seed=3, device=device, n_gaussians=96, n_frames=3,
                                          n_virtual=2, size=32)
    return Trainer(_cfg(packed, densify), ds, device=device, mesh=mesh)


def _traced(tmp_path, fn):
    """The `chs.*` host spans of the Chrome trace `profiling.trace` writes
    around `fn()`: (name, start, end, unit), in start order."""
    with profiling.trace(str(tmp_path)):
        fn()
    (path,) = tmp_path.iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"], e["args"].get("unit"))
                   for e in events if e.get("ph") == "X" and e["name"].startswith("chs.")),
                  key=lambda s: s[1])


def _children(spans, parent):
    """The spans inside `parent`'s interval, but `parent` itself."""
    _, lo, hi, _ = parent
    return [s for s in spans if s is not parent and lo <= s[1] and s[2] <= hi]


@pytest.fixture
def marks(monkeypatch):
    """The boundaries `profiling.mark` is called with, in order."""
    seen = []
    monkeypatch.setattr(profiling, "mark", lambda boundary, like: seen.append(boundary))
    return seen


def test_span_records_a_chs_range_with_its_unit(tmp_path):
    def body():
        with profiling.span("outer", 7):
            with profiling.span("outer.inner", 7):
                torch.ones(4).sum()
        with profiling.span("plain"):
            pass

    spans = _traced(tmp_path, body)
    assert [(n, u) for n, _, _, u in spans] == [("chs.outer", 7), ("chs.outer.inner", 7),
                                                ("chs.plain", None)]
    assert [s[0] for s in _children(spans, spans[0])] == ["chs.outer.inner"]


def test_span_without_a_profiler_is_one_shared_no_op(tmp_path):
    assert not profiling.recording()
    a, b = profiling.span("step", 3), profiling.span("request.lock", 4)
    assert a is b
    with a:
        pass
    # a profiler started afterwards sees none of them
    assert _traced(tmp_path, lambda: torch.ones(2).sum()) == []


def test_step_spans_nested_and_in_order(tmp_path):
    t = _trainer(densify=True)
    spans = _traced(tmp_path, lambda: (t.run_step(), t.run_step()))
    steps = [s for s in spans if s[0] == "chs.step"]
    assert [s[3] for s in steps] == [0, 1]
    # the round is due after the second step (densify.interval 2)
    for step, parts in zip(steps, (["lock", "prepare", "launch", "read"],
                                   ["lock", "prepare", "launch", "round", "read"])):
        inner = _children(spans, step)
        assert [n for n, _, _, _ in inner] == [f"chs.step.{p}" for p in parts]
        assert {u for _, _, _, u in inner} == {step[3]}
        assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))  # one after another


def test_request_spans_nested_and_in_order(tmp_path):
    t = _trainer()
    render = make_orbit_render_fn(t, radius=3.0)
    render(0.1, 0.0, "hdr")  # the request before: ordinal 0
    images = []
    spans = _traced(tmp_path, lambda: images.append(render(0.4, -0.5, "ldr")))
    assert images[0].shape == (32, 32, 3)
    (request,) = [s for s in spans if s[0] == "chs.request"]
    assert request[3] == 1
    inner = _children(spans, request)
    assert [n for n, _, _, _ in inner] == [
        f"chs.request.{p}" for p in ("camera", "lock", "launch", "copy_out")]
    assert {u for _, _, _, u in inner} == {1}
    assert all(a[2] <= b[1] for a, b in zip(inner, inner[1:]))


def test_a_build_that_runs_nvcc_is_a_span_and_a_built_library_none(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    runs = []

    def nvcc(cmd, **kw):
        runs.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(cuda_build.subprocess, "run", nvcc)
    first = _traced(tmp_path / "first", lambda: cuda_build.build("trace_mark.cu"))
    again = _traced(tmp_path / "again", lambda: cuda_build.build("trace_mark.cu"))
    assert len(runs) == 1
    assert [(n, u) for n, _, _, u in first] == [("chs.kernel.build", "trace_mark.cu")]
    assert again == []


def test_marks_are_no_ops_off_cuda():
    for boundary in profiling.MARKS:
        profiling.mark(boundary, torch.zeros(1))
    # nothing was built or loaded: this machine's torch has no card
    assert profiling._MARK._fn is None
    with pytest.raises(KeyError):
        profiling.mark("nowhere", torch.zeros(1))


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_step_reaches_its_boundaries_in_order(marks, packed):
    t = _trainer(packed=packed)
    marks.clear()  # the synthetic video rendered its frames
    t.run_step()
    assert marks == STEP


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo world of one in this process and its mesh (1, 1)."""
    import torch.distributed as dist

    from casualhdrsplat_torch.parallel.mesh import Mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rendezvous", world_size=1,
                            rank=0)
    try:
        yield Mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_mesh_step_reaches_its_boundaries_in_order(marks, world_of_one, packed):
    """The sharded render on a (1, 1) mesh over gloo: the same boundaries."""
    t = _trainer(packed=packed, mesh=world_of_one)
    marks.clear()
    t.run_step()
    assert marks == STEP


@pytest.mark.parametrize("mode", ["ldr", "hdr", "depth"])
def test_render_pose_reaches_its_boundaries_in_order(marks, mode):
    t = _trainer()
    marks.clear()
    with torch.no_grad():
        imf.render_pose(t.params, t.scene, torch.as_tensor(t.dataset.viewmats[1]),
                        t.cfg.model, exposure=torch.tensor(0.4), hdr_output=mode == "hdr",
                        depth_output=mode == "depth")
    assert marks == RENDER


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the marks and graphs run only on the card")
    return torch.device("cuda")


def _device_marks(prof):
    """The marks' names in the device trace of `prof`, in start order."""
    events = [e for e in prof.events() if e.name.startswith("chs_mark_")
              and e.device_type == torch.autograd.DeviceType.CUDA]
    return [e.name[len("chs_mark_"):] for e in sorted(events, key=lambda e: e.time_range.start)]


@pytest.mark.cuda
def test_marks_launch_without_moving_a_launch_counter(cuda):
    before = [c.launches for c in cuda_build.COUNTERS]
    x = torch.zeros(1, device=cuda)
    for boundary in profiling.MARKS:
        profiling.mark(boundary, x)
    torch.cuda.synchronize()
    assert [c.launches for c in cuda_build.COUNTERS] == before


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_replayed_step_and_render_show_their_marks(cuda, packed):
    from torch.profiler import ProfilerActivity, profile

    t = _trainer(cuda, packed=packed)
    render = make_orbit_render_fn(t, radius=3.0)
    for _ in range(3):  # warm-up, capture, replay
        t.run_step()
        render(0.2, 0.0, "ldr")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t.run_step()
        t.run_step()
        render(0.3, 0.1, "ldr")
    torch.cuda.synchronize()
    assert _device_marks(prof) == STEP + STEP + RENDER


@pytest.mark.cuda
def test_graphed_call_counts_and_captures_in_a_span(cuda, tmp_path):
    x = torch.randn(64, device=cuda)
    call = cuda_graphs.GraphedCall(lambda: (x * 2 + 1).sum(), "a tiny graph")
    call()  # the eager warm-up
    assert (call.captures, call.replays, call.nodes) == (0, 0, 0)
    spans = _traced(tmp_path, call)
    assert (call.captures, call.replays) == (1, 1)
    assert [(n, u) for n, _, _, u in spans] == [("chs.graph.capture", "a tiny graph")]
    call()
    assert (call.captures, call.replays) == (1, 2)
    assert call.nodes >= 2 and cuda_graphs.GRAPH_NODES["a tiny graph"] == call.nodes
    assert list(cuda_graphs.GRAPH_NODES)[-1] == "a tiny graph"


# the kernels CUDA runs for some of a replayed graph's memset and memcpy
# nodes, which the device trace reports as kernels (CUDA 12.8): not kernel
# nodes
NODE_COPIES = ("memset32", "memcpy128", "memcpy32_post")


def _replay_kernels(prof):
    """The kernels of the device trace of `prof` from its first mark to its
    last, the marks included, but CUDA's for memset and memcpy nodes."""
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [e for e in events if e.name.startswith("chs_mark_")]
    lo, hi = marks[0].time_range.start, marks[-1].time_range.end
    return [e for e in events if lo <= e.time_range.start <= hi
            and not e.name.startswith(("Memcpy", "Memset")) and e.name not in NODE_COPIES]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "dense"])
def test_step_nodes_equal_the_kernels_a_replay_runs(cuda, packed):
    """`nodes`, counted in the graph at its capture, against the kernels the
    profiler sees one replay run, counted on the card."""
    from torch.profiler import ProfilerActivity, profile

    t = _trainer(cuda, packed=packed)
    for _ in range(3):  # warm-up, capture, replay
        t.run_step()
    call = t._step_graphs.call
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t.run_step()
    torch.cuda.synchronize()
    kernels = _replay_kernels(prof)
    assert call.captures == 1 and call.nodes == len(kernels) > 1000
    assert cuda_graphs.GRAPH_NODES[call.name] == call.nodes
    assert sum(e.name.startswith("chs_mark_") for e in kernels) == len(STEP)
