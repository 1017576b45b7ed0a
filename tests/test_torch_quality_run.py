"""Port parity: casualhdrsplat_torch.quality_run against the reference's
scripts/quality_run.py: `build_fixture` on the knobs of
tests/test_quality_fixture.py, `crf_recovery_rmse` and
`hdr_recovery_metrics` on carried parameters, and a short run of `main` on
the CPU (stopped early, then resumed to completion) whose report holds the
reference's keys, and `eval_aligned` on the checkpoint it leaves.

Tolerances: the fixture's images within 1e-4 (the reference renders its
ground truth through its XLA compositor on a CPU, the port through the
plain version of its packed one; float32 and a 1/2.2 power); a fixture one
package cached reads back equal in the other; the recovery metrics within
1e-5 relative (float32 renders through the two compositors), computed
unrounded."""

import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch import quality_run as t_quality
from casualhdrsplat_torch.models import image_formation as t_imf
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.models import crf as j_crf
from casualhdrsplat_tpu.models import image_formation as j_imf
from casualhdrsplat_tpu.train import metrics as j_metrics
from test_quality_fixture import TINY_KNOBS
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the keys of the reference's report (QUALITY_r05.json) on every exit path,
# and the two a completed run adds
REPORT_KEYS = {"round", "run_label", "fixture", "scale", "wall_s", "exposure_recovery",
               "crf_recovery", "hdr_recovery", "pose_recovery", "psnr_curve", "final_eval",
               "deblurring_gain_db"}
COMPLETED_KEYS = {"final_eval_aligned", "deblurring_gain_db_aligned"}


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def j_quality():
    """The reference's scripts/quality_run.py (on sys.path through
    test_quality_fixture), imported in the test as that file imports it:
    its import sets up the TPU runtime's compile cache."""
    import quality_run

    return quality_run


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory, j_quality):
    """(reference video, dataset), (port video, dataset) built fresh by each
    package, and the port's read from the reference's cache."""
    root = tmp_path_factory.mktemp("fixture")
    cwd = os.getcwd()
    os.chdir(root)  # the reference caches under ./outputs/fixture_cache
    try:
        ref = j_quality.build_fixture(dict(TINY_KNOBS))
    finally:
        os.chdir(cwd)
    mine = t_quality.build_fixture(dict(TINY_KNOBS), device="cpu",
                                   cache_dir=str(root / "torch_cache"))
    read = t_quality.build_fixture(dict(TINY_KNOBS), device="cpu",
                                   cache_dir=str(root / "outputs" / "fixture_cache"))
    return ref, mine, read, root


def test_build_fixture_matches_reference(fixtures):
    (video_j, ds_j), (video_t, ds_t), _, root = fixtures
    assert os.listdir(root / "torch_cache") == os.listdir(root / "outputs" / "fixture_cache")
    for f in ("means3d", "quats", "scales", "opacities", "colors"):
        np.testing.assert_array_equal(_np(getattr(video_t.cloud, f)),
                                      np.asarray(getattr(video_j.cloud, f)), err_msg=f)
    assert ds_t.images.shape == ds_j.images.shape == (3, 48, 48, 3)
    np.testing.assert_allclose(ds_t.images, ds_j.images, atol=1e-4)
    np.testing.assert_allclose(ds_t.sharp_images, ds_j.sharp_images, atol=1e-4)
    np.testing.assert_allclose(_np(video_t.sharp_hdr), np.asarray(video_j.sharp_hdr), atol=1e-4)
    np.testing.assert_allclose(ds_t.viewmats, ds_j.viewmats, atol=1e-6)
    for f in ("timestamps", "points_xyz", "points_rgb"):
        np.testing.assert_array_equal(getattr(ds_t, f), getattr(ds_j, f), err_msg=f)
    for f in ("fx", "fy", "cx", "cy", "width", "height"):
        assert getattr(ds_t, f) == getattr(ds_j, f), f


def test_build_fixture_reads_the_reference_cache(fixtures):
    (video_j, ds_j), _, (video_r, ds_r), _ = fixtures
    for f in ("images", "sharp_images", "viewmats", "timestamps", "points_xyz", "points_rgb"):
        np.testing.assert_array_equal(getattr(ds_r, f), getattr(ds_j, f), err_msg=f)
    for f in ("sharp_hdr", "exposures", "knots"):
        np.testing.assert_array_equal(_np(getattr(video_r, f)), np.asarray(getattr(video_j, f)))


def _unrounded(monkeypatch, j_quality):
    """The metrics round their results; compare them before that."""
    for mod in (t_quality, j_quality):
        monkeypatch.setattr(mod, "round", lambda x, nd=None: x, raising=False)


@pytest.mark.parametrize("seed", [1, 2])
def test_crf_recovery_rmse_matches(monkeypatch, seed, j_quality):
    cfg_j = j_config.CRFConfig(kind="mlp", hidden=8)
    cfg_t = t_config.CRFConfig(kind="mlp", hidden=8)
    rng = np.random.default_rng(seed)
    p_j = {k: np.asarray(v) + (0.2 * rng.normal(size=v.shape)).astype(np.float32)
           for k, v in j_crf.create(cfg_j, jax.random.PRNGKey(seed)).items()}
    p_t = {k: torch.as_tensor(v) for k, v in p_j.items()}
    got = t_quality.crf_recovery_rmse(p_t, cfg_t, gamma=2.2)
    want = j_quality.crf_recovery_rmse({k: jnp.asarray(v) for k, v in p_j.items()}, cfg_j,
                                       gamma=2.2)
    assert got["log_shift"] == want["log_shift"]
    assert got["rmse"] == pytest.approx(want["rmse"], rel=1e-5)


def test_hdr_recovery_metrics_match(fixtures, monkeypatch, j_quality):
    """On the reference's fixture, with the reference's init (perturbed by
    a numpy draw) carried into the port."""
    _unrounded(monkeypatch, j_quality)
    (video_j, ds_j), _, (video_r, ds_r), _ = fixtures
    mk = dict(max_gaussians=256, sh_degree=1, num_virtual_views=2, knots_per_frame=2)
    raster = dict(tile_h=16, tile_w=16, chunk=32, shared_binning=False)
    cfg_j = j_config.ModelConfig(**mk, crf=j_config.CRFConfig(hidden=8),
                                 rasterize=j_config.RasterizeConfig(**raster))
    cfg_t = t_config.ModelConfig(**mk, crf=t_config.CRFConfig(hidden=8),
                                 rasterize=t_config.RasterizeConfig(**raster))
    scene_j = j_imf.build_scene(ds_j, cfg_j)
    params = j_imf.init_params(scene_j, ds_j.points_xyz, ds_j.points_rgb, cfg_j,
                               jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(5)
    np_params["gaussians"]["opacity_logit"] += 2.0
    np_params["knot_deltas"] = (0.002 * rng.normal(size=np_params["knot_deltas"].shape)
                                ).astype(np.float32)
    np_params["log_exposures"] += rng.uniform(-0.2, 0.2, 3).astype(np.float32)
    params_j = jax.tree_util.tree_map(jnp.asarray, np_params)
    render_j = jax.jit(lambda p, fid, deg: j_imf.render_deblurred(
        p, scene_j, fid, cfg_j, hdr_output=True, sh_degree=deg)[0], static_argnums=2)
    t_j = SimpleNamespace(params=params_j, _eval_render_deblurred_hdr=render_j)
    t_t = SimpleNamespace(params=convert.params_from_jax(np_params, device="cpu"),
                          scene=t_imf.build_scene(ds_r, cfg_t, device="cpu"),
                          cfg=SimpleNamespace(model=cfg_t), renders=t_imf.GraphedRenders())
    eval_idx = [0, 1, 2]
    got = t_quality.hdr_recovery_metrics(t_t, video_r, eval_idx, 1, cfg_t.crf)
    want = j_quality.hdr_recovery_metrics(t_j, video_j, eval_idx, 1, cfg_j.crf)
    assert got["eval_hdr_psnr"] == pytest.approx(want["eval_hdr_psnr"], rel=1e-5)
    assert got["scale_gauge"] == pytest.approx(want["scale_gauge"], rel=1e-5)
    assert got["exposure_sweep_psnr"].keys() == want["exposure_sweep_psnr"].keys()
    for k, v in want["exposure_sweep_psnr"].items():
        assert got["exposure_sweep_psnr"][k] == pytest.approx(v, rel=1e-5), k


# the fixture of TINY_KNOBS, trained at 2 views
RUN = ["--device", "cpu", "--size", "48", "--gt-gaussians", "200", "--frames", "3",
       "--capacity", "512", "--virtual-views", "2", "--knots-per-frame", "2",
       "--exposure-lo", "0.3", "--exposure-hi", "0.6", "--shake-rot", "0.03",
       "--shake-trans", "0.015",
       "--steps", "6", "--coarse-steps", "3", "--holdout-every", "0",
       "--densify-start", "100000", "--eval-every-s", "99999", "--eval-every-steps", "2",
       "--align-steps", "3", "--run-label", "torch-cpu-test"]


def test_run_stopped_early_then_resumed(tmp_path, monkeypatch, fixtures):
    """A run stopped by --max-minutes after its first step leaves a scored
    report with the reference's keys and a checkpoint; the next launch
    resumes from it, crosses the promotion to full resolution and finishes
    with the aligned eval.  The initial knots are the reference's own draw,
    and the report's initial pose error is the reference's for them."""
    monkeypatch.chdir(tmp_path)
    shape_seen = []

    def reference_draw(shape, device):
        shape_seen.append(tuple(shape))
        return torch.as_tensor(0.002 * np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                                                    tuple(shape))))
    monkeypatch.setattr(t_quality, "initial_knot_deltas", reference_draw)
    out = str(tmp_path / "q" / "QUALITY_r07_test.json")
    (video_j, ds_j), _, _, root = fixtures
    # the reference's cached fixture
    args = RUN + ["--out", out, "--render-dir", str(tmp_path / "q"),
                  "--fixture-cache", str(root / "outputs" / "fixture_cache")]
    assert t_quality.main(args + ["--fresh", "--max-minutes", "1e-9"]) == 0
    report = json.load(open(out))
    assert REPORT_KEYS <= set(report) and not COMPLETED_KEYS & set(report)
    assert report["round"] == 7 and report["run_label"] == "torch-cpu-test"
    assert report["device"] == "cpu" and report["rasterize"]["chunk"] == 256
    assert report["scale"]["steps_done"] == 1 and len(report["psnr_curve"]) == 1
    point = report["psnr_curve"][0]
    assert point["res"] == 24 and np.isfinite(point["eval_sharp_psnr"])
    assert "eval_hdr_psnr" in report["hdr_recovery"]
    assert os.path.exists(out + ".progress")

    # the initial pose error: the reference's metric on the same knots
    cfg_j = j_config.ModelConfig(knots_per_frame=2, max_gaussians=512)
    scene_j = j_imf.build_scene(ds_j.downscaled(2), cfg_j)
    deltas = 0.002 * jax.random.normal(jax.random.PRNGKey(3), shape_seen[0])
    times = j_metrics.exposure_window_times(video_j.timestamps, video_j.exposures)
    rot, trans = j_metrics.trajectory_recovery_errors(
        video_j.knots, video_j.knot_t0, video_j.knot_dt,
        j_imf.effective_knots({"knot_deltas": deltas}, scene_j),
        scene_j.knot_t0, scene_j.knot_dt, jnp.asarray(times, jnp.float32))
    pose = report["pose_recovery"]
    assert pose["init_rot_deg_mean"] == pytest.approx(float(rot.mean()), rel=1e-3)
    assert pose["init_trans_mean"] == pytest.approx(float(trans.mean()), rel=1e-3)

    # resume to the end: promotion at step 3, evals at 2, 4 and 6
    assert t_quality.main(args) == 0
    report = json.load(open(out))
    assert REPORT_KEYS | COMPLETED_KEYS <= set(report)
    curve = report["psnr_curve"]
    assert [p["step"] for p in curve] == [1, 2, 4, 6]
    assert [p["res"] for p in curve] == [24, 24, 48, 48]
    assert report["scale"]["steps_done"] == 6
    for p in curve:
        assert all(np.isfinite(v) for v in (p["loss"], p["eval_psnr"], p["eval_sharp_psnr"]))
    aligned = report["final_eval_aligned"]
    assert aligned["at_step"] == 6 and "3 Adam steps" in aligned["protocol"]
    assert len(aligned["align_deltas"]) == 3 and np.isfinite(aligned["eval_sharp_psnr_aligned"])
    # the resume window (3 newest) plus the best eval's checkpoint
    ckpt = tmp_path / "q" / "ckpt"
    best = json.load(open(ckpt / "BEST.json"))["step"]
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt) if d.startswith("step_"))
    assert steps[-3:] == [2, 4, 6] and best in steps
    assert sorted(os.listdir(tmp_path / "q"))[:3] == ["QUALITY_r07_test.json",
                                                      "QUALITY_r07_test.json.progress",
                                                      "ckpt"]

    # eval_aligned on the finished run's checkpoint: the same fixture and
    # step, its block merged into the report, the aligned renders written
    from casualhdrsplat_torch import eval_aligned

    assert eval_aligned.main(["--out", out, "--render-dir", str(tmp_path / "q"),
                              "--fixture-cache", str(root / "outputs" / "fixture_cache"),
                              "--steps", "2", "--device", "cpu"]) == 0
    again = json.load(open(out))["final_eval_aligned"]
    assert again["at_step"] == 6 and "2 Adam steps" in again["protocol"]
    assert again["eval_sharp_psnr_input"] == aligned["eval_sharp_psnr_input"]
    assert again["eval_sharp_psnr_raw"] == pytest.approx(aligned["eval_sharp_psnr_raw"],
                                                         abs=1e-3)
    assert "eval_novel_psnr_raw" not in again and again["wall_s"] >= 0
    assert sorted(f for f in os.listdir(tmp_path / "q") if f.startswith("deblur_aligned")) == [
        f"deblur_aligned_{i:03d}.png" for i in range(3)]


def test_main_needs_the_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_quality.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
