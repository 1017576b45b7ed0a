"""Port parity: ops/projection.py, ops/sh.py, ops/knn.py,
models/gaussians.py and data/synthetic.py against the JAX reference.

Tolerances: SH and activation at atol 1e-6; projected means at 1e-4 px;
conics at rtol 1e-5 + atol 2e-6 (O(1) entries whose off-diagonal cancels
in float32); integer-valued radii and validity masks equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch.data import synthetic as t_syn
from casualhdrsplat_torch.models import gaussians as t_gauss
from casualhdrsplat_torch.ops import knn as t_knn
from casualhdrsplat_torch.ops import projection as t_proj
from casualhdrsplat_torch.ops import sh as t_sh
from casualhdrsplat_tpu.data import synthetic as j_syn
from casualhdrsplat_tpu.models import gaussians as j_gauss
from casualhdrsplat_tpu.ops import knn as j_knn
from casualhdrsplat_tpu.ops import projection as j_proj
from casualhdrsplat_tpu.ops import sh as j_sh


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_eval_sh(rng, degree):
    coeffs = rng.normal(size=(50, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(50, 3)).astype(np.float32)
    out_t = t_sh.eval_sh(degree, _t(coeffs), _t(dirs))
    out_j = j_sh.eval_sh(degree, jnp.asarray(coeffs), jnp.asarray(dirs))
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)
    rgb = rng.uniform(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(t_sh.rgb_to_sh_dc(_t(rgb)), j_sh.rgb_to_sh_dc(jnp.asarray(rgb)),
                               atol=1e-6)


def test_synthetic_scene_sources():
    cloud_t = t_syn.random_cloud(np.random.default_rng(3), 40, scale_range=(0.004, 0.02),
                                 device="cpu")
    cloud_j = j_syn.random_cloud(np.random.default_rng(3), 40, scale_range=(0.004, 0.02))
    for a, b in zip(cloud_t, cloud_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cam_t = t_syn.orbit_camera(0.3, width=48, img_height=40, device="cpu")
    cam_j = j_syn.orbit_camera(0.3, width=48, img_height=40)
    np.testing.assert_allclose(cam_t.viewmat, cam_j.viewmat, atol=1e-6)
    for f in ("fx", "fy", "cx", "cy"):
        assert float(getattr(cam_t, f)) == float(getattr(cam_j, f))
    np.testing.assert_allclose(t_syn.orbit_knots(5, device="cpu"), j_syn.orbit_knots(5),
                               atol=1e-6)


def test_knn_and_gaussian_store(rng):
    xyz = rng.uniform(-1, 1, size=(60, 3)).astype(np.float32)
    rgb = rng.uniform(size=(60, 3)).astype(np.float32)
    np.testing.assert_allclose(t_knn.knn_mean_dist(xyz), j_knn.knn_mean_dist(xyz), rtol=1e-5)
    st = t_gauss.create(xyz, rgb, 64, sh_degree=2, device="cpu")
    sj = j_gauss.create(xyz, rgb, 64, sh_degree=2)
    assert set(st) == set(sj)
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), atol=1e-5, err_msg=k)
    # random SH so that the view-dependent bases do real work
    sh_rest = rng.normal(size=(64, 8, 3)).astype(np.float32) * 0.3
    st["sh_rest"], sj["sh_rest"] = _t(sh_rest), jnp.asarray(sh_rest)
    act_t, act_j = t_gauss.activate(st), j_gauss.activate(sj)
    for a, b in zip(act_t, act_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    c2w = np.asarray(j_syn.orbit_camera(0.2).camtoworld())
    np.testing.assert_allclose(t_gauss.colors_for_view(act_t, _t(c2w), 2),
                               j_gauss.colors_for_view(act_j, jnp.asarray(c2w), 2), atol=1e-6)
    assert int(st["alive"].sum()) == int(j_gauss.num_alive(sj)) == 60


@pytest.mark.parametrize("antialias", [False, True])
def test_project_gaussians_batched_views(rng, antialias):
    cloud = j_syn.random_cloud(rng, 80, extent=1.5)
    cams = [j_syn.orbit_camera(a, width=40, img_height=32) for a in (0.0, 0.4, 2.5)]
    cam = cams[0]
    vms = np.stack([np.asarray(c.viewmat) for c in cams])
    opac = np.asarray(cloud.opacities).copy()
    opac[::5] = 0.0  # dead slots
    proj_t = t_proj.cull_invisible(t_proj.project_gaussians(
        _t(cloud.means3d), _t(cloud.quats), _t(cloud.scales), _t(vms),
        _t(cam.fx), _t(cam.fy), _t(cam.cx), _t(cam.cy), 40, 32, antialias=antialias,
    ), _t(opac))
    for k, c in enumerate(cams):
        proj_j = j_proj.cull_invisible(j_proj.project_gaussians(
            cloud.means3d, cloud.quats, cloud.scales, c.viewmat, cam.fx, cam.fy,
            cam.cx, cam.cy, 40, 32, antialias=antialias,
        ), jnp.asarray(opac))
        np.testing.assert_array_equal(proj_t.valid[k], proj_j.valid)
        np.testing.assert_array_equal(proj_t.radii[k], proj_j.radii)
        np.testing.assert_allclose(proj_t.means2d[k], proj_j.means2d, atol=1e-4)
        np.testing.assert_allclose(proj_t.depths[k], proj_j.depths, atol=1e-6)
        np.testing.assert_allclose(proj_t.conics[k], proj_j.conics, rtol=1e-5, atol=2e-6)
        np.testing.assert_allclose(proj_t.compensation[k], proj_j.compensation, atol=1e-6)
    assert proj_t.valid.any() and not proj_t.valid.all()
    dirs_t = t_proj.view_directions(_t(cloud.means3d), _t(np.asarray(cams[1].camtoworld())))
    dirs_j = j_proj.view_directions(cloud.means3d, cams[1].camtoworld())
    np.testing.assert_allclose(dirs_t, dirs_j, atol=1e-6)
