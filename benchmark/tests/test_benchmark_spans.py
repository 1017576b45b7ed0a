"""The readers of the program's spans and marks (benchmark/spans.py and the
per-layer metrics that use it) against a `TraceReading` built from
hand-written Chrome trace events: the arithmetic of a layer's device time,
the host's gap between steps, a request's copy-out and host part, and
None where one mark is missing or the program left none (a parent without
them)."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, spans, tracing

ROOT = harness.ROOT
TRAIN_LAYERS = {  # reader: (first mark, second mark)
    "project_ms.train": ("step_begin", "project"),
    "bin_ms.train": ("project", "bin"),
    "composite_ms.train": ("bin", "composite"),
    "crf_loss_ms.train": ("composite", "loss"),
    "backward_ms.train": ("loss", "backward"),
    "adam_ms.train": ("backward", "step_end"),
}
STEP_US = 1000.0  # a traced step or request


class _Profile:
    """Stands in for a torch.profiler profile: exports `events`."""

    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _x(name, cat, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _unit(kind, u, drop=None, marks=True):
    """The events of unit `u`: its benchmark range, its program spans and,
    on the device, the marks 10 us apart at 100 us steps with, between mark
    i and mark i + 1, a kernel of (i + 1) * 10 us and an overlapping one of
    half that (busy (i + 1) * 10 us).  `drop` leaves that mark out."""
    t0 = u * STEP_US * 2
    order = spans.ORDER[kind]
    events = [_x("bench.step" if kind == "train" else "bench.request", "user_annotation", t0,
                 STEP_US)]
    for i, name in enumerate(order):
        at = t0 + 50 + 100 * i
        if marks and name != drop:
            events.append(_x(spans.MARK + name, "kernel", at, 2))
        if i + 1 < len(order):
            events.append(_x(f"work_{i}", "kernel", at + 5, (i + 1) * 10))
            events.append(_x(f"side_{i}", "kernel", at + 6, (i + 1) * 5))
    if kind == "train":
        events += [_x("chs.step", "cpu_op", t0 + 1, STEP_US + 8),  # into the next bin
                   _x("chs.step.launch", "cpu_op", t0 + 10, 20),
                   _x("chs.step.read", "cpu_op", t0 + 700, 290)]
    else:
        events += [_x("chs.request", "cpu_op", t0 + 1, STEP_US - 2),
                   _x("chs.request.copy_out", "cpu_op", t0 + 600, 390),
                   _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", t0 + 620, 300),
                   _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", t0 + 930, 10)]
    return events


def _reading(kind, units=3, per_unit=None):
    """A reading of `units` units; `per_unit` maps a unit to `_unit`'s
    keywords."""
    per_unit = per_unit or {}
    events = [e for u in range(units) for e in _unit(kind, u, **per_unit.get(u, {}))]
    return tracing.TraceReading(kind, units, _Profile(events), lambda: None, {})


def _read(name, t):
    return tracing.load_reader(ROOT, name)(t)


@pytest.mark.parametrize("name", sorted(TRAIN_LAYERS))
def test_a_training_layer_is_the_busy_time_between_its_marks(name):
    first, _ = TRAIN_LAYERS[name]
    i = spans.ORDER["train"].index(first)
    assert _read(name, _reading("train")) == pytest.approx((i + 1) * 10 * 1e-3)


def test_the_six_layers_cover_the_busy_time_between_a_steps_first_and_last_marks():
    t = _reading("train")
    layers = sum(_read(name, t) for name in TRAIN_LAYERS)
    marks = 7 * 2 * 1e-3  # 7 marks of 2 us a step
    assert layers == pytest.approx(t.busy_s / t.units * 1e3 - marks)


def test_bin_ms_serve_reads_the_render_marks():
    t = _reading("serve")
    assert _read("bin_ms.serve", t) == pytest.approx(20 * 1e-3)
    assert _read("bin_ms.train", t) is None


def test_step_host_ms_is_the_gap_from_a_read_to_the_next_launch():
    # a read ends at 990 us into its step, the next launch starts at 10 us
    # into the next one, STEP_US * 2 after the first
    assert _read("step_host_ms.train", _reading("train")) == pytest.approx(
        (2 * STEP_US + 10 - 990) * 1e-3)


def test_copy_out_is_the_device_to_host_copy_inside_its_span():
    assert _read("copy_out_ms.serve", _reading("serve")) == pytest.approx(0.3)


def test_request_host_ms_is_the_request_less_its_device_time():
    t = _reading("serve")
    # the request's 998 us less the work between 5 marks (10 + 20 + 30 + 40),
    # 5 marks of 2 us and the copies (300 + 10)
    want = (STEP_US - 2) - (100 + 5 * 2 + 310)
    assert _read("request_host_ms.serve", t) == pytest.approx(want * 1e-3)


@pytest.mark.parametrize("kind,names", [("train", sorted(TRAIN_LAYERS)),
                                        ("serve", ["bin_ms.serve"])])
@pytest.mark.parametrize("dropped", ["first", "middle", "last"])
def test_nothing_to_read_when_one_mark_is_missing(kind, names, dropped):
    order = spans.ORDER[kind]
    mark = {"first": order[0], "middle": order[2], "last": order[-1]}[dropped]
    t = _reading(kind, per_unit={1: {"drop": mark}})
    assert spans.unit_marks(t) is None
    assert all(_read(name, t) is None for name in names)


def test_nothing_to_read_when_the_marks_run_out_of_order():
    t = _reading("train")
    # the second step's bin mark recorded after its composite mark
    name, s, e = next(d for d in t.device if d[0] == spans.MARK + "bin" and d[1] > STEP_US)
    t.device = [d for d in t.device if d[1] != s] + [(name, s + 150, e + 150)]
    t.device.sort(key=lambda d: d[1])
    assert spans.unit_marks(t) is None and _read("bin_ms.train", t) is None


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_program_without_marks_or_spans_gives_nothing(kind, monkeypatch):
    """The parent: no marks, no `chs.*` spans, no node count."""
    from casualhdrsplat_torch.utils import cuda_graphs

    monkeypatch.delattr(cuda_graphs, "GRAPH_NODES")
    events = [e for u in range(3) for e in _unit(kind, u, marks=False)
              if not e["name"].startswith("chs.")]
    t = tracing.TraceReading(kind, 3, _Profile(events), lambda: None, {})
    names = [m["name"] for m in harness.load_spec()["per_layer"]
             if m["source"] in ("program_span", "program_counter")]
    assert len(names) == 11
    for name in names:
        assert _read(name, t) is None, name


def test_step_kernels_reads_the_programs_count_of_the_step_graph(monkeypatch):
    from casualhdrsplat_torch.utils import cuda_graphs

    t = _reading("train")
    monkeypatch.setattr(cuda_graphs, "GRAPH_NODES", {
        "the training step (SH degree 2)": 4100, "render_pose (hdr False, depth False)": 900,
        "the training step (SH degree 3)": 4466, "the density-control round": 300})
    assert _read("step_kernels.train", t) == 4466.0
    assert _read("step_kernels.train", _reading("serve")) is None
    monkeypatch.delattr(cuda_graphs, "GRAPH_NODES")
    assert _read("step_kernels.train", t) is None


def test_host_spans_are_taken_once_across_bins():
    t = _reading("train")
    # every step's span ends in the millisecond after its start's
    assert len(spans.host_spans(t, "chs.step")) == 3
    assert sum(e[0] == "chs.step" for events in t.host.values() for e in events) == 6
