"""Port parity for the whole serving slice: models/image_formation.py
(render_frame with shared binning over V=2 virtual views, render_pose with
V=1, render_deblurred) against the JAX reference at
`__graft_entry__._tiny_setup(backend="pallas")` size.  Parameters are
carried across with `convert.params_from_jax` after a numpy-seeded
perturbation, so the trajectory, exposures and view-dependent SH all do
real work.

Tolerances: images atol 1e-5 (float32 through the pose spline, projection,
compositor and CRF); poses atol 1e-5; binning counters equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch.models import image_formation as t_imf
from casualhdrsplat_tpu.models import image_formation as j_imf

ATOL = 1e-5


def _port_cfg(cfg):
    d = dataclasses.asdict(cfg)
    return t_config.ModelConfig(
        **{k: v for k, v in d.items() if k not in ("crf", "rasterize")},
        crf=t_config.CRFConfig(**d["crf"]),
        rasterize=t_config.RasterizeConfig(**d["rasterize"]),
    )


@pytest.fixture(scope="module")
def setup():
    ds, cfg, scene, params = __graft_entry__._tiny_setup(backend="pallas")
    rng = np.random.default_rng(11)
    np_params = jax.tree_util.tree_map(lambda a: np.array(a), params)
    g = np_params["gaussians"]
    g["sh_rest"] = (rng.normal(size=g["sh_rest"].shape) * 0.2).astype(np.float32)
    g["opacity_logit"] = g["opacity_logit"] + 2.0  # visibly opaque splats
    np_params["knot_deltas"] = (rng.normal(size=np_params["knot_deltas"].shape)
                                * 0.01).astype(np.float32)
    np_params["log_exposures"] = rng.uniform(-0.7, 0.3, size=3).astype(np.float32)
    j_params = jax.tree_util.tree_map(jnp.asarray, np_params)
    t_params = convert.params_from_jax(np_params, device="cpu")
    t_scene = convert.scene_from_numpy(scene, device="cpu")
    return ds, cfg, scene, j_params, _port_cfg(cfg), t_scene, t_params


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def test_build_scene_and_init_params(setup):
    ds, cfg, scene, _, t_cfg, t_scene, _ = setup
    built = t_imf.build_scene(ds, t_cfg, device="cpu")
    for f in ("base_knots", "knot_t0", "knot_dt", "timestamps", "fx", "fy", "cx", "cy"):
        _close(getattr(built, f), getattr(scene, f), atol=1e-6)
        _close(getattr(t_scene, f), getattr(scene, f), atol=0)
    assert (built.width, built.height) == (scene.width, scene.height)
    t_init = t_imf.init_params(built, ds.points_xyz, ds.points_rgb, t_cfg)
    j_init = j_imf.init_params(scene, ds.points_xyz, ds.points_rgb, cfg, jax.random.PRNGKey(0))
    for k, v in j_init["gaussians"].items():
        _close(t_init["gaussians"][k], v)
    _close(t_init["knot_deltas"], j_init["knot_deltas"], atol=0)
    _close(t_init["log_exposures"], j_init["log_exposures"], atol=0)
    assert set(t_init["crf"]) == set(j_init["crf"])


def test_poses_and_exposure(setup):
    _, cfg, scene, j_params, t_cfg, t_scene, t_params = setup
    _close(t_imf.effective_knots(t_params, t_scene), j_imf.effective_knots(j_params, scene))
    times = np.array([0.1, 0.7, 1.9], np.float32)
    poses_j = jax.jit(lambda p, t: j_imf.poses_at(p, scene, t, cfg))
    _close(t_imf.poses_at(t_params, t_scene, torch.from_numpy(times), t_cfg),
           poses_j(j_params, jnp.asarray(times)))
    _close(t_imf.exposure_of(t_params, 2), j_imf.exposure_of(j_params, 2), atol=1e-6)
    demand_j = jax.jit(lambda p: j_imf.shared_binning_demand(p, scene, 1, cfg))
    for a, b in zip(t_imf.shared_binning_demand(t_params, t_scene, 1, t_cfg),
                    demand_j(j_params)):
        assert int(a) == int(b)


@pytest.mark.parametrize("shared", [True, False])
def test_render_frame(setup, shared):
    _, cfg, scene, j_params, t_cfg, t_scene, t_params = setup
    cfg = dataclasses.replace(cfg, rasterize=dataclasses.replace(
        cfg.rasterize, shared_binning=shared))
    t_cfg = _port_cfg(cfg)
    out_j = jax.jit(lambda p: j_imf.render_frame(p, scene, 1, cfg))(j_params)
    out_t = t_imf.render_frame(t_params, t_scene, 1, t_cfg)
    assert out_t.sharp_hdr.shape == (2, 32, 32, 3)
    for f in ("blurred_ldr", "sharp_ldr", "sharp_hdr", "alphas"):
        _close(getattr(out_t, f), getattr(out_j, f))
    assert int(out_t.aux.num_dropped) == int(out_j.aux.num_dropped)
    assert float(out_t.alphas.max()) > 0.5


def test_render_pose_and_deblurred(setup):
    _, cfg, scene, j_params, t_cfg, t_scene, t_params = setup
    vm = np.asarray(j_imf.poses_at(j_params, scene, jnp.asarray([0.8]), cfg)[0])

    @jax.jit
    def pose_j(p, vm, exposure):
        return (j_imf.render_pose(p, scene, vm, cfg, exposure=exposure)[:2],
                j_imf.render_pose(p, scene, vm, cfg, hdr_output=True)[0],
                j_imf.render_pose(p, scene, vm, cfg, depth_output=True)[0],
                j_imf.render_deblurred(p, scene, 2, cfg)[0])

    (ldr_j, al_j), hdr_j, depth_j, deblur_j = pose_j(j_params, jnp.asarray(vm),
                                                    jnp.asarray(0.7))
    vm_t = torch.from_numpy(vm.copy())
    ldr_t, al_t, _ = t_imf.render_pose(t_params, t_scene, vm_t, t_cfg,
                                       exposure=torch.tensor(0.7))
    _close(ldr_t, ldr_j)
    _close(al_t, al_j)
    _close(t_imf.render_pose(t_params, t_scene, vm_t, t_cfg, hdr_output=True)[0], hdr_j)
    # depth = composited z / alpha: z ~ 4, so 1e-5 relative
    _close(t_imf.render_pose(t_params, t_scene, vm_t, t_cfg, depth_output=True)[0],
           depth_j, atol=5e-5)
    _close(t_imf.render_deblurred(t_params, t_scene, 2, t_cfg)[0], deblur_j)
