"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of a cell's files by name (a new cell is files and entries, no
edit)."""

from __future__ import annotations

import json
import re
import shutil
import statistics

import pytest

from benchmark import harness, loops, tracing

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SPEC = harness.load_spec()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    named = [w for w in SPEC["command"] if w.endswith(".py")]
    assert named and all(any(w.startswith(p + "/") for p in SPEC["paths"]) for w in named)


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_unique_and_well_formed(section):
    names = [e["name"] for e in SPEC[section]]
    assert len(names) == len(set(names)) and 1 <= len(names)
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert json.loads((ROOT / c["file"]).read_text())["config"]["model"]


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]]
        # every cell that lists the metric reports the metric it moves
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in SPEC["end_to_end"] if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert any(w in m.get("workloads", cells) for m in SPEC["per_layer"])


def test_bounds_follow_the_rule():
    """No bound under 1%, none over 25%, setup_s at 25%."""
    bounds = [m["bound"] for m in SPEC["end_to_end"] if m["name"] != "setup_s"]
    assert min(bounds) >= 0.01 and max(bounds) <= 0.25
    assert statistics.mean(bounds) <= 0.25


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(workload):
    cell = harness.resolve(SPEC, workload)
    assert cell.limits and hasattr(loops.load_kind(cell.traffic["kind"]), "window")
    assert cell.per_layer and cell.end_to_end
    for m in cell.per_layer:
        assert callable(tracing.load_reader(ROOT, m["name"]))


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A later cell adds a configuration, a mix of a new kind with its loop,
    limits and a metric as new files and new entries; the harness finds
    them without an edit."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/ladder4-full.json").read_text())
    cfg["name"] = "ladder4-big"
    (tmp_path / "benchmark/configs/ladder4-big.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "benchmark/traffic/serve.json").read_text())
    mix.update(kind="serve_live", sample=4)
    (tmp_path / "benchmark/traffic/serve-few.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark/kinds/serve_live.py").write_text(
        "from benchmark.loops import BaseLoop\n\n\nclass Loop(BaseLoop):\n"
        "    def window(self, seconds):\n        return {}\n")
    (tmp_path / "benchmark/limits/ladder4-big.serve-few.json").write_text('{"image_gap": 1}')
    (tmp_path / "benchmark/metrics/b1_seconds.serve.py").write_text(
        "def read(t):\n    return t.kernel_seconds(('rasterize_packed_fwd_kernel',))\n")
    spec["configs"].append({"name": "ladder4-big", "source": "https://example.org",
                            "file": "benchmark/configs/ladder4-big.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "ladder4-big.serve-few", "config": "ladder4-big",
                              "traffic": "serve-few", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"].startswith("render_"):
            m["workloads"].append("ladder4-big.serve-few")
    spec["per_layer"].append({"name": "b1_seconds.serve", "unit": "s",
                              "better": "lower", "source": "device_trace", "layer": "kernels",
                              "moves": "render_p50_ms", "workloads": ["ladder4-big.serve-few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve(harness.load_spec(tmp_path), "ladder4-big.serve-few", tmp_path)
    assert cell.config["name"] == "ladder4-big" and cell.traffic["sample"] == 4
    kind = loops.load_kind(cell.traffic["kind"], tmp_path)
    assert issubclass(kind, loops.BaseLoop) and kind.window(None, 1) == {}
    assert [m["name"] for m in cell.per_layer][-1] == "b1_seconds.serve"
    assert {m["name"] for m in cell.end_to_end} == {"render_p50_ms", "render_p95_ms", "setup_s"}
    assert tracing.load_reader(tmp_path, "b1_seconds.serve") is not None
