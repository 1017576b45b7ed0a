"""The ladder5-pod configuration and its cell scene3m.train: the file is the
program's preset 5 but for the keys under `reduced`, its scene ladder4's
recipe with the stated changes (24 times the Gaussians, finer scales, the
camera closer so that the cloud fills the frame, a larger ground-truth
tile capacity), and the cell reports what BENCHMARK.json lists for it."""

from __future__ import annotations

import json
import types

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.load_spec()
FILE = json.loads((ROOT / "benchmark/configs/ladder5-pod.json").read_text())


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_config_is_preset_5_but_for_its_reduced_keys():
    from casualhdrsplat_torch import config

    (entry,) = [c for c in SPEC["configs"] if c["name"] == "ladder5-pod"]
    assert entry["reduced"] == FILE["reduced"] == ["parallel.data", "parallel.gauss"]
    preset = _flat(config.to_dict(config.preset_5_pod()))
    ours = _flat(FILE["config"])
    assert set(ours) == set(preset)
    changed = {k for k in preset if ours[k] != preset[k]}
    assert changed == set(entry["reduced"])
    assert (ours["parallel.data"], ours["parallel.gauss"]) == (1, 1)
    assert ours["model.max_gaussians"] == 3 << 20
    # the program builds this tree unchanged
    assert config.to_dict(config.from_dict(FILE["config"])) == FILE["config"]


def test_scene_is_ladder4s_recipe_at_24_times_the_gaussians():
    l4 = json.loads((ROOT / "benchmark/configs/ladder4-full.json").read_text())["assumed"]
    scene, base = FILE["assumed"]["scene"], l4["scene"]
    assert {k for k in base if scene[k] != base[k]} == {"gaussians", "scale_range", "radius",
                                                        "gt_tile_capacity"}
    assert scene["gaussians"] == FILE["config"]["model"]["max_gaussians"]
    ratio = 24 ** (1.0 / 3.0)
    for lo, hi in zip(scene["scale_range"], base["scale_range"]):
        assert abs(lo * ratio / hi - 1.0) < 5e-3  # three digits
    assert scene["gt_tile_capacity"] % 128 == 0
    assert set(FILE["assumed"]["state"]) == set(l4["state"])
    assert set(FILE["assumed"]["state"]["adam_nu_rms"]) == set(l4["state"]["adam_nu_rms"])


def test_cell_reports_the_training_metrics_and_the_knn():
    cell = harness.resolve(SPEC, "scene3m.train")
    assert cell.chips == 1 and cell.traffic["kind"] == "train"
    assert {m["name"] for m in cell.end_to_end} == {"train_mpix_s", "train_peak_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "mfu.train", "train.idle_pct", "b2_roofline.train", "project_ms.train", "bin_ms.train",
        "composite_ms.train", "crf_loss_ms.train", "backward_ms.train", "adam_ms.train",
        "step_host_ms.train", "step_kernels.train", "knn_ms.train"}
    ladder4 = json.loads((ROOT / "benchmark/limits/ladder4.train.json").read_text())
    assert cell.limits == ladder4
    for other in ("ladder4.train", "ladder4-dense.train"):
        assert "knn_ms.train" in {m["name"] for m in harness.resolve(SPEC, other).per_layer}


def test_knn_reader_reads_the_programs_record_and_nothing_else(monkeypatch):
    from casualhdrsplat_torch.ops import knn

    from benchmark import tracing

    read = tracing.load_reader(ROOT, "knn_ms.train")
    monkeypatch.setattr(knn, "LAST", None)
    assert read(types.SimpleNamespace(kind="train")) is None
    monkeypatch.setattr(knn, "LAST", knn.KnnCall(3 << 20, "grid", 1234.5))
    assert read(types.SimpleNamespace(kind="train")) == 1234.5
    assert read(types.SimpleNamespace(kind="serve")) is None
    # a program that keeps no record (the parent of this metric) reads None
    monkeypatch.delattr(knn, "LAST")
    assert read(types.SimpleNamespace(kind="train")) is None


def _frame_cells_reached(name, radius, gaussians):
    """Share of the first frame's 8x8-pixel cells that hold the projected
    centre of a kept Gaussian, for the named configuration's scene at this
    orbit radius and this many Gaussians."""
    import torch

    from benchmark import scene
    from benchmark.reference import render as ref

    spec = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())["assumed"]["scene"]
    spec = dict(spec, radius=radius, gaussians=gaussians)
    cloud = scene.make_cloud(torch.Generator().manual_seed(2147483713), spec, "cpu")
    with torch.no_grad():
        p = ref.project(cloud["means"], cloud["quats"], cloud["scales"], cloud["opacities"],
                        scene.orbit_poses(spec, "cpu")[:1], scene.camera(spec), 0.05)
    size = spec["size"]
    xy = p.means2d[0][p.valid[0]]
    xy = xy[((xy >= 0) & (xy < size)).all(-1)].long() // 8
    cells = torch.zeros((size // 8) ** 2, dtype=torch.bool)
    cells[xy[:, 1] * (size // 8) + xy[:, 0]] = True
    return float(cells.float().mean())


def test_ladder5s_scene_fills_the_frame_and_ladder4s_does_not():
    # a casual video of a real scene shows the scene in every pixel: at 2.2
    # a 12th of the cell's Gaussians already reach all but a few cells
    # (3,145,728 reach every one)
    scene = FILE["assumed"]["scene"]
    assert _frame_cells_reached("ladder5-pod", scene["radius"], 1 << 18) > 0.99
    # ladder4's camera at 4.0 sees the cloud as an object on black
    assert _frame_cells_reached("ladder5-pod", 4.0, 1 << 18) < 0.4
