"""Port parity: data/synthetic.make_casual_video (renderer="fast") and
data/dataset.py against the reference with the same numpy seed.  The
reference renders its ground truth with RasterizeConfig(backend="pallas",
packed=True, shared_binning=False) (kernel B1 in interpret mode), the port
through its plain compositor.

Tolerances: images atol 1e-4 (float32 through the spline, projection and
compositor, then a 1/2.2 power, whose slope is steep near black);
timestamps and exposures equal (the same numpy draws); knots atol 1e-6."""

import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.data import synthetic as t_synth
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.data import dataset as j_dataset
from casualhdrsplat_tpu.data import synthetic as j_synth

RASTER = dict(tile_h=8, tile_w=16, chunk=32, shared_binning=False, packed=True)


def _cfgs(**kw):
    merged = dict(RASTER, **kw)
    return (t_config.RasterizeConfig(**merged),
            j_config.RasterizeConfig(backend="pallas", **merged))


VIDEO_CASES = {
    "plain": dict(n_gaussians=60, n_frames=3, n_virtual=3, size=32),
    "shake": dict(n_gaussians=60, n_frames=3, n_virtual=2, size=32, shake_rot=0.02,
                  shake_trans=0.01, exposure_range=(0.5, 0.9)),
    "dense_knots": dict(n_gaussians=60, n_frames=3, n_virtual=2, size=32,
                        knots_per_frame=3),
    "no_blur": dict(n_gaussians=60, n_frames=2, n_virtual=4, size=32, blur=False,
                    hdr_max=1.0, crf_gamma=1.8),
}


@pytest.mark.parametrize("case", list(VIDEO_CASES))
def test_make_casual_video_matches_jax(case):
    kw = VIDEO_CASES[case]
    cfg_t, cfg_j = _cfgs()
    vid_t = t_synth.make_casual_video(np.random.default_rng(5), raster_cfg=cfg_t,
                                      device="cpu", **kw)
    vid_j = j_synth.make_casual_video(np.random.default_rng(5), renderer="fast",
                                      raster_cfg=cfg_j, **kw)
    for f in t_synth.GaussianCloud._fields:
        np.testing.assert_array_equal(getattr(vid_t.cloud, f), getattr(vid_j.cloud, f))
    np.testing.assert_array_equal(vid_t.timestamps, vid_j.timestamps)
    np.testing.assert_array_equal(vid_t.exposures, vid_j.exposures)
    np.testing.assert_allclose(vid_t.knots, vid_j.knots, atol=1e-6)
    assert (vid_t.knot_t0, vid_t.knot_dt) == pytest.approx((vid_j.knot_t0, vid_j.knot_dt))
    for f in ("images", "sharp_hdr", "sharp_ldr"):
        a, b = getattr(vid_t, f).numpy(), np.asarray(getattr(vid_j, f))
        assert a.shape == b.shape and a.max() > 0.05
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f)
    assert (vid_t.camera.width, float(vid_t.camera.fx)) == (vid_j.camera.width,
                                                            float(vid_j.camera.fx))


def test_truncated_ground_truth_raises():
    cfg_t, _ = _cfgs(stream_factor=1, tile_h=8, tile_w=8)
    with pytest.raises(ValueError, match="overflowed the rasterizer"):
        t_synth.make_casual_video(np.random.default_rng(0), n_gaussians=400, n_frames=2,
                                  n_virtual=2, size=16, raster_cfg=cfg_t, device="cpu")


def test_unported_sources_raise():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="unknown renderer"):
        t_synth.make_casual_video(rng, renderer="raytrace", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_synth.make_casual_video(rng, cloud_kind="structured", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_dataset.load_dataset(t_config.DataConfig(source="colmap"), device="cpu")
    with pytest.raises(ValueError, match="unknown data source"):
        t_dataset.load_dataset(t_config.DataConfig(source="tape"), device="cpu")


def test_synthetic_dataset_matches_jax():
    cfg_t, cfg_j = _cfgs()
    kw = dict(n_gaussians=50, n_frames=5, n_virtual=2, size=20, knots_per_frame=2)
    ds_t = t_dataset.make_synthetic_dataset(seed=3, device="cpu", raster_cfg=cfg_t, **kw)
    ds_j = j_dataset.make_synthetic_dataset(seed=3, renderer="fast", raster_cfg=cfg_j, **kw)
    for f in ("timestamps", "points_xyz", "points_rgb"):
        np.testing.assert_array_equal(getattr(ds_t, f), getattr(ds_j, f))
    np.testing.assert_allclose(ds_t.viewmats, ds_j.viewmats, atol=1e-6)
    np.testing.assert_allclose(ds_t.images, ds_j.images, atol=1e-4)
    np.testing.assert_allclose(ds_t.sharp_images, ds_j.sharp_images, atol=1e-4)
    for f in ("fx", "fy", "cx", "cy", "width", "height", "num_frames"):
        assert getattr(ds_t, f) == getattr(ds_j, f)
    assert ds_t.scene_extent() == pytest.approx(ds_j.scene_extent(), rel=1e-6)
    # the container's methods
    ds_t.split(2), ds_j.split(2)
    np.testing.assert_array_equal(ds_t.train_indices, ds_j.train_indices)
    np.testing.assert_array_equal(ds_t.eval_indices, ds_j.eval_indices)
    half_t, half_j = ds_t.downscaled(2), ds_j.downscaled(2)
    np.testing.assert_allclose(half_t.images, half_j.images, atol=1e-4)
    assert (half_t.width, half_t.fx, half_t.cx) == (half_j.width, half_j.fx, half_j.cx)
    np.testing.assert_array_equal(half_t.eval_indices, ds_j.eval_indices)
    assert ds_t.downscaled(1) is ds_t
    cam_t, cam_j = ds_t.camera(1, device="cpu"), ds_j.camera(1)
    np.testing.assert_allclose(cam_t.viewmat, cam_j.viewmat, atol=1e-6)
    np.testing.assert_array_equal(ds_t.camera(device="cpu").viewmat, np.eye(4, dtype=np.float32))
    # no points: the extent falls back to the camera positions
    ds_t.points_xyz = ds_t.points_xyz[:0]
    ds_j.points_xyz = ds_j.points_xyz[:0]
    assert ds_t.scene_extent() == pytest.approx(ds_j.scene_extent(), rel=1e-6)


def test_config_tree_round_trip():
    """TrainConfig: the reference's fields and defaults (but for its
    `parallel` section), to_dict / from_dict, and the presets."""
    d_t = t_config.to_dict(t_config.TrainConfig())
    d_j = j_config.to_dict(j_config.TrainConfig())
    d_j.pop("parallel")
    assert d_t == d_j
    for name, make in t_config.PRESETS.items():
        d_t, d_j = t_config.to_dict(make()), j_config.to_dict(j_config.PRESETS[name]())
        d_j.pop("parallel")
        assert d_t == d_j, name
    cfg = t_config.PRESETS["ladder3"]()
    cfg.optim.pose_b1 = 0.0
    cfg.model.rasterize.chunk = 64
    back = t_config.from_dict(t_config.to_dict(cfg))
    assert back == cfg and isinstance(back.model.rasterize, t_config.RasterizeConfig)
    assert t_config.from_dict({"seed": 4}).seed == 4
    with pytest.raises(ValueError, match="unknown config keys"):
        t_config.from_dict({"model": {"no_such_field": 1}})
