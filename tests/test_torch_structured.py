"""Port parity: data/synthetic.structured_cloud, make_casual_video with the
structured cloud, and the .npz fixture cache, against the reference with
the same numpy seed.

Tolerances: the cloud is equal bit for bit (numpy draws and float32
arithmetic in the reference's order); the rendered video within 1e-4
(float32 through the spline, the oracle's compositing and a 1/2.2 power,
whose slope is steep near black); a cached fixture reads back equal."""

import os

import numpy as np
import pytest
import torch

from casualhdrsplat_torch.data import synthetic as t_synth
from casualhdrsplat_torch.models import losses as t_losses
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.data import synthetic as j_synth
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

VIDEO_FIELDS = ("images", "sharp_hdr", "sharp_ldr", "timestamps", "exposures", "knots")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n,seed", [(4000, 0), (300, 4)])
def test_structured_cloud_equals_reference_bit_for_bit(n, seed):
    got = t_synth.structured_cloud(np.random.default_rng(seed), n, extent=2.2, hdr_max=3.0,
                                   device="cpu")
    want = j_synth.structured_cloud(np.random.default_rng(seed), n, extent=2.2, hdr_max=3.0)
    for f in t_synth.GaussianCloud._fields:
        a, b = _np(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_structured_cloud_is_piecewise_smooth():
    """The properties the reference's own test holds its cloud to."""
    cloud = t_synth.structured_cloud(np.random.default_rng(0), 4000, extent=2.2, hdr_max=3.0,
                                     device="cpu")
    n = cloud.means3d.shape[0]
    assert abs(n - 4000) < 500
    for leaf in cloud:
        assert bool(torch.isfinite(leaf).all())
    # spatial colour correlation: the nearest neighbour's colour is far
    # closer than a random point's (confetti scores about 1)
    pts, col = cloud.means3d.numpy(), cloud.colors.numpy()
    sub = np.arange(0, n, 7)[:400]
    d2 = ((pts[sub, None] - pts[None]) ** 2).sum(-1)
    d2[np.arange(len(sub)), sub] = np.inf
    nn = d2.argmin(1)
    nn_dist = np.linalg.norm(col[sub] - col[nn], axis=1).mean()
    rand = np.linalg.norm(col[sub] - col[np.roll(sub, 17)], axis=1).mean()
    assert nn_dist < 0.6 * rand, (nn_dist, rand)
    # the HDR window: radiance above the LDR clip
    assert (col.max(-1) > 1.5).sum() > 10
    # unit quaternions, w >= 0; flat surfels (third scale a tenth)
    q = cloud.quats.numpy()
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-6)
    assert (q[:, 0] >= 0).all()
    s = cloud.scales.numpy()
    np.testing.assert_allclose(s[:, 2], np.maximum(0.1 * s[:, 0], 1e-4), rtol=1e-5)


SHAKE_KW = dict(n_gaussians=300, n_frames=3, n_virtual=5, size=48, angle_span=0.3,
                exposure_range=(0.3, 0.6), crf_gamma=2.2, extent=2.2, hdr_max=3.0,
                knots_per_frame=3, cloud_kind="structured", renderer="oracle")


@pytest.fixture(scope="module")
def shake_videos():
    """(still, shaken) from each package: the reference's shake test on the
    structured cloud."""
    out = {}
    for name, shake in (("still", {}), ("shaken", dict(shake_rot=0.15, shake_trans=0.05))):
        out[name] = (
            t_synth.make_casual_video(np.random.default_rng(4), device="cpu", **SHAKE_KW,
                                      **shake),
            j_synth.make_casual_video(np.random.default_rng(4), **SHAKE_KW, **shake),
        )
    return out


@pytest.mark.parametrize("name", ["still", "shaken"])
def test_structured_video_matches_reference(shake_videos, name):
    got, want = shake_videos[name]
    for f in t_synth.GaussianCloud._fields:
        np.testing.assert_array_equal(_np(getattr(got.cloud, f)),
                                      np.asarray(getattr(want.cloud, f)), err_msg=f)
    np.testing.assert_array_equal(_np(got.exposures), np.asarray(want.exposures))
    np.testing.assert_allclose(_np(got.knots), np.asarray(want.knots), atol=1e-6)
    for f in ("images", "sharp_hdr", "sharp_ldr"):
        a, b = _np(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.shape == b.shape == ((3, 48, 48, 3)) and a.max() > 0.05, f
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f)


def test_structured_shake_blurs_the_inputs(shake_videos):
    def in_psnr(v):
        return float(np.mean([float(t_losses.psnr(v.images[i], v.sharp_ldr[i]))
                              for i in range(v.images.shape[0])]))

    still, shaken = shake_videos["still"][0], shake_videos["shaken"][0]
    assert in_psnr(shaken) < in_psnr(still) - 3.0, (in_psnr(shaken), in_psnr(still))
    # dense knots on the dense grid: (F-1)*k + k + 2*pad + 1
    assert shaken.knots.shape[0] == (3 - 1) * 3 + 3 + 4 + 1


# the shake videos' cloud and image size: the reference's eager oracle has
# its operations compiled for these shapes already
CACHE_KW = dict(n_gaussians=300, n_frames=2, n_virtual=2, size=48, exposure_range=(0.3, 0.6),
                cloud_kind="structured", renderer="oracle", shake_rot=0.02, extent=2.2)


def _assert_same_video(a, b):
    for f in t_synth.GaussianCloud._fields:
        np.testing.assert_array_equal(_np(getattr(a.cloud, f)), _np(getattr(b.cloud, f)))
    for f in VIDEO_FIELDS:
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)), err_msg=f)
    assert (a.knot_t0, a.knot_dt) == (b.knot_t0, b.knot_dt)
    for f in ("viewmat", "fx", "fy", "cx", "cy", "width", "height"):
        np.testing.assert_array_equal(_np(getattr(a.camera, f)), _np(getattr(b.camera, f)))


def test_cached_video_is_shared_with_the_reference(tmp_path, shake_videos):
    """The same key and fields: each package writes one file of the same
    name, and reads the other's back as its writer made it."""
    t_dir, j_dir = str(tmp_path / "torch"), str(tmp_path / "jax")
    # raster_cfg (a different class in each package) stays out of the key
    made_t = t_synth.cached_casual_video(t_dir, 7, device="cpu", **CACHE_KW,
                                         raster_cfg=object())
    made_j = j_synth.cached_casual_video(j_dir, 7, **CACHE_KW,
                                         raster_cfg=j_config.RasterizeConfig())
    names = os.listdir(t_dir)
    assert names == os.listdir(j_dir) and len(names) == 1
    assert names[0].startswith("video_") and names[0].endswith(".npz")
    for f in VIDEO_FIELDS:
        np.testing.assert_allclose(_np(getattr(made_t, f)), np.asarray(getattr(made_j, f)),
                                   atol=1e-4, err_msg=f)
    # each reads the other's file; a hit renders nothing
    _assert_same_video(t_synth.cached_casual_video(j_dir, 7, device="cpu", **CACHE_KW), made_j)
    _assert_same_video(j_synth.cached_casual_video(t_dir, 7, **CACHE_KW), made_t)
    # a fixture-shaping change misses the cache
    t_synth.cached_casual_video(t_dir, 7, device="cpu", **dict(CACHE_KW, shake_rot=0.03))
    assert len(os.listdir(t_dir)) == 2
