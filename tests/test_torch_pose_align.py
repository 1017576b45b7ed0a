"""Port parity: train/pose_align.py (`make_aligner`, `make_window_realigner`)
against the JAX package, plus the behavioural checks of
tests/test_pose_align.py run against the port.

Both packages start from the same dataset and parameters (the
reference's, through numpy) on tests/test_pose_align.py's fixture: the
dense path (`packed=False`, backend "xla" in both) and the packed default
(the reference on its Pallas kernels in interpret mode, the port on the
plain versions of its kernels).  After 8 Adam steps:
- the loss curve: atol 2e-6 + rtol 1e-4 (the renders agree to ~1e-6 a
  pixel, and so do their mean errors);
- the se(3) correction: atol 2e-2 lr.  Adam's steps are lr * m / sqrt(v),
  so the gradients' ~1e-4 relative agreement moves each step by ~1e-4 lr;
  8 steps stay far inside 2e-2 lr, the tolerance the trainers are held to
  after five steps (tests/test_torch_train_step.py);
- the aligned render: atol 1e-4; the re-baked knot deltas: atol 1e-5.

The window of the last frame clips its knot indices, so the last knot
appears four times.  The reference's `.at[idx].set` gives the
correction the gradient of one write; a port whose scatter counted every
copy would take other steps, and the comparison there fails.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.geometry import lie as t_lie
from casualhdrsplat_torch.models import image_formation as t_imf
from casualhdrsplat_torch.train import pose_align as t_pa
from casualhdrsplat_torch.train.trainer import Trainer as TorchTrainer
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.data import dataset as j_dataset
from casualhdrsplat_tpu.geometry import lie as j_lie
from casualhdrsplat_tpu.models import image_formation as j_imf
from casualhdrsplat_tpu.train import pose_align as j_pa
from casualhdrsplat_tpu.train.trainer import Trainer as JaxTrainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

STEPS = 8
REALIGN_LR = 5e-3
# the injected offsets of tests/test_pose_align.py
XI_POSE = [0.012, -0.009, 0.015, 0.01, -0.008, 0.012]
XI_WINDOW = [0.02, -0.015, 0.02, 0.01, -0.01, 0.015]


def _cfg(mod, packed: bool):
    """tests/test_pose_align.py's config in either package."""
    cfg = mod.TrainConfig(name="pose-align-test")
    cfg.model.max_gaussians = 128
    cfg.model.sh_degree = 1
    cfg.model.num_virtual_views = 4
    cfg.model.crf.kind = "gamma"
    if packed:
        raster = dict(tile_h=8, tile_w=16, max_tiles_per_gaussian=32, chunk=32)
        if mod is j_config:
            raster["backend"] = "pallas"
    else:
        raster = dict(tile_h=8, tile_w=16, tile_capacity=128, max_tiles_per_gaussian=32,
                      chunk=32, backend="xla", packed=False)
    cfg.model.rasterize = mod.RasterizeConfig(**raster)
    cfg.densify.enabled = False
    cfg.data.eval_every = 0
    cfg.log_every = 10**9
    cfg.eval_every = 0
    cfg.checkpoint_every = 0
    return cfg


def _port_dataset(seed):
    """tests/test_pose_align.py's synthetic fixture, rendered by the port
    (its fast renderer; the reference's oracle takes far longer here)."""
    return t_dataset.make_synthetic_dataset(seed=seed, n_gaussians=60, n_frames=4, n_virtual=4,
                                            size=32, angle_span=0.8,
                                            exposure_range=(0.3, 0.5), device="cpu")


def make_pair(packed: bool):
    """(reference trainer, port trainer, the reference's realigner) on one
    dataset and one parameter set, with visibly opaque splats."""
    ds_t = _port_dataset(7)
    ds_j = j_dataset.Dataset(**{f.name: getattr(ds_t, f.name)
                                for f in dataclasses.fields(t_dataset.Dataset)})
    tj = JaxTrainer(_cfg(j_config, packed), ds_j)
    np_params = jax.tree_util.tree_map(lambda a: np.array(a), tj.params)
    np_params["gaussians"]["opacity_logit"] += 2.0
    tj.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tt = TorchTrainer(_cfg(t_config, packed), ds_t, device="cpu")
    tt.params = convert.params_from_jax(np_params, device="cpu")
    # the reference's realigner compiles once and serves every frame
    realign_j = j_pa.make_window_realigner(tj.cfg.model, steps=STEPS, lr=REALIGN_LR)
    return tj, tt, realign_j


@pytest.fixture(scope="module", params=[False, True], ids=["dense", "packed"])
def pair(request):
    return make_pair(request.param)


def _close_delta(got, ref, lr):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-2 * lr)


def test_aligner_matches_reference(pair):
    tj, tt, _ = pair
    lr = 3e-3
    dt_j = j_imf.exposure_of(tj.params, 1)
    vm_j = j_imf.poses_at(tj.params, tj.scene, jnp.array([tj.scene.timestamps[1] + 0.5 * dt_j]),
                          tj.cfg.model)[0]
    target_j, _, _ = j_imf.render_pose(tj.params, tj.scene, vm_j, tj.cfg.model, exposure=dt_j)
    vm_off = j_lie.mat_mul(j_lie.se3_exp(jnp.asarray(XI_POSE, jnp.float32)), vm_j)
    img_j, delta_j, curve_j = j_pa.make_aligner(tj.cfg.model, steps=STEPS, lr=lr)(
        tj.params, tj.scene, vm_off, dt_j, target_j)

    img_t, delta_t, curve_t = t_pa.make_aligner(tt.cfg.model, steps=STEPS, lr=lr)(
        tt.params, tt.scene, torch.as_tensor(np.array(vm_off)),
        torch.as_tensor(np.array(dt_j)), torch.as_tensor(np.array(target_j)))
    np.testing.assert_allclose(curve_t.numpy(), np.asarray(curve_j), rtol=1e-4, atol=2e-6)
    assert float(curve_t[-1]) < float(curve_t[0])
    _close_delta(delta_t, delta_j, lr)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    assert not any(p.requires_grad for p in tt.params["gaussians"].values())


def _window(scene_j, params_j, frame):
    """The realigner's knot window of `frame`, as the reference clips it."""
    t_i = float(scene_j.timestamps[frame])
    j0 = int(np.floor((t_i - float(scene_j.knot_t0)) / float(scene_j.knot_dt))) - 1
    return np.clip(np.arange(j0, j0 + 7), 0, params_j["knot_deltas"].shape[0] - 1)


@pytest.mark.parametrize("frame", [0, 3], ids=["start", "end"])
def test_window_realigner_matches_reference(pair, frame):
    check_window_realigner(pair, frame)


def check_window_realigner(pair, frame):
    tj, tt, realign_j = pair
    lr = REALIGN_LR
    idx = _window(tj.scene, tj.params, frame)
    # the last frame's window runs off the end of the trajectory (so does
    # the middle frame's, by one knot), the first frame's fits
    assert (len(np.unique(idx)) < len(idx)) == (frame == 3), idx
    target_j = j_imf.render_frame(tj.params, tj.scene, frame, tj.cfg.model).blurred_ldr
    kd = tj.params["knot_deltas"]
    xi = jnp.asarray(XI_WINDOW, jnp.float32)
    pert = jnp.stack([j_lie.se3_log(j_lie.mat_mul(j_lie.se3_exp(xi), j_lie.se3_exp(r)))
                      for r in kd[jnp.asarray(idx)]])
    broken_j = {**tj.params, "knot_deltas": kd.at[jnp.asarray(idx)].set(pert)}
    kd_j, d_j, curve_j = realign_j(broken_j, tj.scene, jnp.asarray(frame), target_j)

    broken_t = {**tt.params, "knot_deltas": torch.as_tensor(np.array(broken_j["knot_deltas"]))}
    kd_t, d_t, curve_t = t_pa.make_window_realigner(tt.cfg.model, steps=STEPS, lr=lr)(
        broken_t, tt.scene, frame, torch.as_tensor(np.array(target_j)))
    np.testing.assert_allclose(curve_t.numpy(), np.asarray(curve_j), rtol=1e-4, atol=2e-6)
    assert float(curve_t[-1]) < float(curve_t[0])
    _close_delta(d_t, d_j, lr)
    np.testing.assert_allclose(kd_t.numpy(), np.asarray(kd_j), rtol=0, atol=1e-5)
    # only the window's knots moved
    moved = np.flatnonzero(np.abs(kd_t.numpy() - np.asarray(broken_j["knot_deltas"])).max(1))
    assert set(moved) <= set(idx) and len(moved) > 0


# -- tests/test_pose_align.py's behaviour, against the port ----------------------


def _port_trainer(seed):
    return TorchTrainer(_cfg(t_config, False), _port_dataset(seed), device="cpu")


@torch.no_grad()
def test_align_removes_known_pose_offset():
    t = _port_trainer(7)
    m = t.cfg.model
    dt = t_imf.exposure_of(t.params, 1)
    vm_true = t_imf.poses_at(t.params, t.scene, (t.scene.timestamps[1] + 0.5 * dt)[None], m)[0]
    target, _, _ = t_imf.render_pose(t.params, t.scene, vm_true, m, exposure=dt)
    xi = torch.tensor(XI_POSE)
    vm_off = t_lie.mat_mul(t_lie.se3_exp(xi), vm_true)
    off_render, _, _ = t_imf.render_pose(t.params, t.scene, vm_off, m, exposure=dt)
    err_before = float(torch.mean(torch.square(off_render - target)))
    with torch.enable_grad():
        aligned, delta, curve = t_pa.make_aligner(m, steps=120, lr=3e-3)(
            t.params, t.scene, vm_off, dt, target)
    err_after = float(torch.mean(torch.square(aligned - target)))
    assert err_after < 0.05 * err_before, (err_before, err_after)
    # the recovered correction inverts the injected rotation (the view-axis
    # translation is only weakly observable, so it is not asserted)
    resid = t_lie.se3_log(t_lie.mat_mul(t_lie.se3_exp(delta), t_lie.se3_exp(xi)))
    assert float(resid[:3].norm()) < 0.35 * float(xi[:3].norm()), (delta, resid)
    assert float(curve[-1]) < float(curve[0])


@torch.no_grad()
def test_window_realigner_recovers_injected_window_offset():
    t = _port_trainer(9)
    m = t.cfg.model
    target = t_imf.render_frame(t.params, t.scene, 1, m).blurred_ldr
    xi = torch.tensor(XI_WINDOW)
    t_i = float(t.scene.timestamps[1])
    j0 = int(np.floor((t_i - float(t.scene.knot_t0)) / float(t.scene.knot_dt))) - 1
    idx = torch.as_tensor(np.clip(np.arange(j0, j0 + 7), 0, t.params["knot_deltas"].shape[0] - 1))
    kd = t.params["knot_deltas"]
    kd[idx] = t_lie.se3_log(t_lie.mat_mul(t_lie.se3_exp(xi), t_lie.se3_exp(kd[idx])))
    l1_broken = float(torch.mean(torch.abs(
        t_imf.render_frame(t.params, t.scene, 1, m).blurred_ldr - target)))
    with torch.enable_grad():
        kd2, d, curve = t_pa.make_window_realigner(m, steps=96, lr=5e-3)(
            t.params, t.scene, 1, target)
    t.params["knot_deltas"] = kd2
    l1_fixed = float(torch.mean(torch.abs(
        t_imf.render_frame(t.params, t.scene, 1, m).blurred_ldr - target)))
    assert l1_fixed < 0.35 * l1_broken, (l1_broken, l1_fixed)
    # the recovered correction points against the injected offset
    assert float(torch.dot(d[:3], -xi[:3])) > 0
    assert float(curve[-1]) < float(curve[0])
