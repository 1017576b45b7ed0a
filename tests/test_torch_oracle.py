"""Port parity: the plain reference renderer ops/oracle.py and
data/synthetic.make_casual_video(renderer="oracle") against the JAX
package's, and the port's dense rasterizer against the port's oracle.

Tolerances: oracle against oracle atol 2e-5 + rtol 1e-4 (float32 products
of up to N transmittance factors, taken in another order by cumprod);
rasterizer against oracle atol 2e-4 + rtol 1e-3, as the reference's own
tests hold its kernels to its oracle (the rasterizer evaluates a splat
only on the tiles its 3-sigma box touches and stops a saturated tile
early); synthetic images atol 1e-4 (a 1/2.2 power, steep near black)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.data import synthetic as t_synth
from casualhdrsplat_torch.geometry.camera import Camera
from casualhdrsplat_torch.ops import oracle as t_oracle
from casualhdrsplat_torch.ops import projection as t_proj
from casualhdrsplat_torch.ops import rasterize as t_rast
from casualhdrsplat_tpu.data import dataset as j_dataset
from casualhdrsplat_tpu.data import synthetic as j_synth
from casualhdrsplat_tpu.ops import oracle as j_oracle
from casualhdrsplat_tpu.ops import projection as j_proj


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cam(cam_j):
    return Camera.make(np.asarray(cam_j.viewmat), float(cam_j.fx), float(cam_j.fy),
                       float(cam_j.cx), float(cam_j.cy), cam_j.width, cam_j.height,
                       device="cpu")


def _cloud(cloud_j):
    return [_t(a) for a in (cloud_j.means3d, cloud_j.quats, cloud_j.scales,
                            cloud_j.opacities, cloud_j.colors)]


@pytest.mark.parametrize("case", ["plain", "background", "antialias", "behind_camera"])
def test_oracle_render_matches_jax(rng, case):
    cloud = j_synth.random_cloud(rng, 80, extent=3.0 if case == "behind_camera" else 1.0)
    cam = j_synth.orbit_camera(0.2, radius=2.0 if case == "behind_camera" else 4.0,
                               width=28, img_height=20)
    bg = np.array([0.1, 0.4, 0.8], np.float32) if case == "background" else None
    aa = case == "antialias"
    ref = j_oracle.render(cloud.means3d, cloud.quats, cloud.scales, cloud.opacities,
                          cloud.colors, cam, None if bg is None else jnp.asarray(bg),
                          antialias=aa)
    out = t_oracle.render(*_cloud(cloud), _cam(cam), None if bg is None else _t(bg),
                          antialias=aa)
    assert out.image.shape == (20, 28, 3) and out.max_weight.shape == (80,)
    np.testing.assert_allclose(out.image, ref.image, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.alpha, ref.alpha, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(out.max_weight, ref.max_weight, atol=2e-5, rtol=1e-4)
    assert float(out.max_weight.max()) > 0.1
    if case == "behind_camera":  # culled Gaussians composite nothing
        assert float(out.max_weight.min()) == 0.0


def test_oracle_composite_is_differentiable_and_matches_jax(rng):
    """`composite` on a given projection, and autograd through it against
    jax.grad of the reference's."""
    import jax

    cloud = j_synth.random_cloud(rng, 40)
    cam = j_synth.orbit_camera(0.0, width=16, img_height=16)
    proj_j = j_proj.project_gaussians(cloud.means3d, cloud.quats, cloud.scales,
                                      cam.viewmat, cam.fx, cam.fy, cam.cx, cam.cy, 16, 16)
    weights = rng.normal(size=(16, 16, 3)).astype(np.float32)

    def loss_j(colors, opac):
        return jnp.sum(j_oracle.composite(proj_j, colors, opac, 16, 16).image * weights)

    g_j = jax.grad(loss_j, argnums=(0, 1))(cloud.colors, cloud.opacities)
    proj_t = t_proj.Projected(*[torch.from_numpy(np.array(f)) for f in proj_j])
    colors = _t(cloud.colors).requires_grad_(True)
    opac = _t(cloud.opacities).requires_grad_(True)
    out = t_oracle.composite(proj_t, colors, opac, 16, 16)
    g_t = torch.autograd.grad((out.image * _t(weights)).sum(), (colors, opac))
    for a, b in zip(g_t, g_j):
        scale = float(np.abs(b).max())
        np.testing.assert_allclose(a, b, atol=1e-4 * scale, rtol=1e-3)
    empty = t_oracle.composite(t_proj.Projected(*[f[:0] for f in proj_t]), colors[:0],
                               opac[:0], 16, 16, background=torch.ones(3))
    assert float(empty.image.min()) == 1.0 and empty.max_weight.shape == (0,)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("tile_h,tile_w,capacity", [(8, 16, 64), (16, 16, 128)])
def test_port_rasterizer_matches_port_oracle(rng, packed, tile_h, tile_w, capacity):
    cloud = j_synth.random_cloud(rng, 60)
    cam = _cam(j_synth.orbit_camera(0.0, width=24, img_height=24))
    cfg = t_config.RasterizeConfig(tile_h=tile_h, tile_w=tile_w, tile_capacity=capacity,
                                   chunk=32, packed=packed, max_tiles_per_gaussian=64)
    args = _cloud(cloud)
    imgs, alphas, aux = t_rast.rasterize(*args, cam.viewmat[None], cam.fx, cam.fy, cam.cx,
                                         cam.cy, 24, 24, cfg)
    ref = t_oracle.render(*args, cam)
    assert int(aux.num_dropped) == 0 and int(aux.num_clipped) == 0
    np.testing.assert_allclose(imgs[0], ref.image, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(alphas[0], ref.alpha, atol=2e-4, rtol=1e-3)


VIDEO_CASES = {
    "plain": dict(n_gaussians=60, n_frames=3, n_virtual=3, size=24),
    "shake": dict(n_gaussians=60, n_frames=2, n_virtual=2, size=24, shake_rot=0.02,
                  shake_trans=0.01, exposure_range=(0.5, 0.9)),
    "no_blur": dict(n_gaussians=60, n_frames=2, n_virtual=4, size=24, blur=False,
                    hdr_max=1.0, crf_gamma=1.8),
}


@pytest.mark.parametrize("case", list(VIDEO_CASES))
def test_make_casual_video_oracle_matches_jax(case):
    kw = VIDEO_CASES[case]
    vid_t = t_synth.make_casual_video(np.random.default_rng(5), renderer="oracle",
                                      device="cpu", **kw)
    vid_j = j_synth.make_casual_video(np.random.default_rng(5), **kw)  # oracle by default
    np.testing.assert_array_equal(vid_t.exposures, vid_j.exposures)
    np.testing.assert_allclose(vid_t.knots, vid_j.knots, atol=1e-6)
    for f in ("images", "sharp_hdr", "sharp_ldr"):
        a, b = getattr(vid_t, f).numpy(), np.asarray(getattr(vid_j, f))
        assert a.shape == b.shape and a.max() > 0.05
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f)


def test_synthetic_dataset_oracle_matches_jax_default():
    """make_synthetic_dataset(renderer="oracle") is the reference's default
    fixture; the port's own default stays renderer="fast"."""
    kw = dict(n_gaussians=50, n_frames=4, n_virtual=2, size=20)
    ds_t = t_dataset.make_synthetic_dataset(seed=3, device="cpu", renderer="oracle", **kw)
    ds_j = j_dataset.make_synthetic_dataset(seed=3, **kw)
    np.testing.assert_allclose(ds_t.images, ds_j.images, atol=1e-4)
    np.testing.assert_allclose(ds_t.sharp_images, ds_j.sharp_images, atol=1e-4)
    fast = t_dataset.make_synthetic_dataset(seed=3, device="cpu", **kw)
    np.testing.assert_allclose(fast.images, ds_t.images, atol=2e-3)
    assert dataclasses.is_dataclass(fast)
