"""Port parity for the training slice as a whole: train/trainer.py against
the reference Trainer with RasterizeConfig(backend="pallas", packed=True),
so that the reference takes the packed path and runs its Pallas kernels B1
and B2 in interpret mode; the port runs the plain versions of its kernels
(CPU tensors).  Both trainers start from the same dataset (the reference's
arrays, through numpy) and the same parameters (convert.params_from_jax),
with an MLP CRF, 2 virtual views, poses and exposures optimized, density
control off.  Plus the port's counterparts of tests/test_train_smoke.py.

Tolerances.
- Scalars after one step: loss atol 1e-6, PSNR atol 1e-4 dB, the dropped
  and clipped counts equal; after five steps loss atol 1e-3 and PSNR 0.05
  dB (the parameters have moved apart by then, as below).
- Gradients of every group and of the means2d tap: atol 1e-4 * scale + rtol
  1e-3, scale = the group's largest gradient magnitude (sums over pixels
  and over a Gaussian's stream slots run in another order in each package).
- Parameters: after one step every element within 5e-3 lr of the
  reference's, after five steps within 2e-2 lr (lr = the group's learning
  rate at update 0), plus two float32 roundings of the leaf's largest value.
  Adam's first updates are lr * g / (|g| + 1e-15): every element moves by
  about lr whatever its gradient's size, so the gradients' 1e-3 relative
  agreement shows as 1e-3 lr in the parameters, and grows with the steps
  (measured here: 1.3e-4 lr after one step, 5.5e-4 lr after five).
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
from casualhdrsplat_torch.train import densify as t_densify
from casualhdrsplat_torch.train import optim as t_optim
from casualhdrsplat_torch.train.trainer import Trainer as TorchTrainer
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.data import dataset as j_dataset
from casualhdrsplat_tpu.models import crf as j_crf
from casualhdrsplat_tpu.models import image_formation as j_imf
from casualhdrsplat_tpu.models import losses as j_losses
from casualhdrsplat_tpu.train.trainer import Trainer as JaxTrainer


def _cfg(mod, **model_kw):
    """The same small training config in either package."""
    cfg = mod.TrainConfig(name="parity")
    cfg.model.max_gaussians = 128
    cfg.model.sh_degree = 1
    cfg.model.num_virtual_views = 2
    cfg.model.crf = mod.CRFConfig(kind="mlp", hidden=8)
    raster = dict(tile_h=8, tile_w=16, max_tiles_per_gaussian=32, chunk=32, packed=True)
    if mod is j_config:
        raster["backend"] = "pallas"
    cfg.model.rasterize = mod.RasterizeConfig(**raster)
    cfg.densify.enabled = False
    cfg.optim.max_steps = 25
    cfg.optim.pose_trans_lr_scale = 0.5
    cfg.loss.pose_anchor_weight = 0.1
    cfg.log_every = 10**9
    cfg.eval_every = 0
    cfg.checkpoint_every = 0
    cfg.data.eval_every = 0
    for k, v in model_kw.items():
        setattr(cfg.model, k, v)
    return cfg


def _port_dataset(ds_j) -> t_dataset.Dataset:
    """The reference's dataset, field by field through numpy."""
    fields = {}
    for f in dataclasses.fields(t_dataset.Dataset):
        v = getattr(ds_j, f.name)
        fields[f.name] = np.array(v) if isinstance(v, (np.ndarray, jax.Array)) else v
    return t_dataset.Dataset(**fields)


@pytest.fixture(scope="module")
def trainers():
    """(reference trainer, port trainer, numpy parameters) from one dataset
    and one parameter set, perturbed so that every group does real work."""
    ds_j = j_dataset.make_synthetic_dataset(seed=3, n_gaussians=96, n_frames=4,
                                            n_virtual=2, size=32)
    tj = JaxTrainer(_cfg(j_config), ds_j)
    rng = np.random.default_rng(11)
    np_params = jax.tree_util.tree_map(lambda a: np.array(a), tj.params)
    g = np_params["gaussians"]
    g["sh_rest"] = (rng.normal(size=g["sh_rest"].shape) * 0.1).astype(np.float32)
    g["opacity_logit"] = g["opacity_logit"] + 2.0
    # anisotropic, rotated splats: the kNN init is isotropic, which leaves
    # the quaternions without a gradient
    g["log_scales"] = g["log_scales"] + (rng.normal(size=g["log_scales"].shape)
                                         * 0.3).astype(np.float32)
    g["quats"] = g["quats"] + (rng.normal(size=g["quats"].shape) * 0.3).astype(np.float32)
    np_params["knot_deltas"] = (rng.normal(size=np_params["knot_deltas"].shape)
                                * 0.005).astype(np.float32)
    np_params["log_exposures"] = np_params["log_exposures"] + rng.uniform(
        -0.3, 0.1, size=4).astype(np.float32)
    tj.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tt = TorchTrainer(_cfg(t_config), _port_dataset(ds_j), device="cpu")
    tt.params = convert.params_from_jax(np_params, device="cpu")
    return tj, tt, np_params


def _loss_j(tj, params, offset, frame_id):
    """The reference trainer's objective (trainer.py, loss_fn of
    _train_step), from the reference's own functions."""
    cfg = tj.cfg
    out = j_imf.render_frame(params, tj.scene, frame_id, cfg.model,
                             sh_degree=cfg.model.sh_degree, means2d_offset=offset)
    loss = j_losses.photometric(out.blurred_ldr, tj.images[frame_id], cfg.loss.ssim_lambda)
    kd = params["knot_deltas"]
    loss = loss + cfg.loss.pose_anchor_weight * jnp.mean(jnp.sum(kd * kd, axis=-1))
    loss = loss + cfg.loss.exposure_prior_weight * j_losses.exposure_prior(
        params["log_exposures"], tj._init_log_exposures)
    loss = loss + cfg.loss.crf_smoothness_weight * j_crf.smoothness_prior(
        params["crf"], cfg.model.crf)
    loss = loss + cfg.loss.crf_chroma_weight * j_crf.chroma_prior(params["crf"], cfg.model.crf)
    return loss, (j_losses.psnr(out.blurred_ldr, tj.images[frame_id]),
                  out.aux.num_dropped, out.aux.num_clipped)


def _check_params(tt, tj, start, lr_share):
    """Every parameter of the port within lr_share * lr (+ two float32
    roundings) of the reference's, and every group moved from `start`."""
    lrs = tt.opt.learning_rates(0)
    for path, label, leaf in t_optim.labelled_leaves(tt.params):
        ref = np.asarray(t_optim.tree_get(tj.params, path))
        if label == "frozen":
            np.testing.assert_array_equal(leaf.numpy(), ref)
            continue
        lr = lrs[label] * (min(1.0, tt.cfg.optim.pose_trans_lr_scale) if label == "pose" else 1.0)
        atol = lr_share * lr + 2.4e-7 * float(np.abs(ref).max())
        np.testing.assert_allclose(leaf.numpy(), ref, atol=atol, rtol=0, err_msg=str(path))
        assert np.abs(ref - np.asarray(t_optim.tree_get(start, path))).max() > 0.0, path


def test_one_step_gradients_and_update_match_jax(trainers):
    tj, tt, np_params = trainers
    assert tj.step == 0 and tt.step == 0
    frame = int(np.random.default_rng(tj.cfg.seed + 2).choice(tj.dataset.train_indices))

    # -- gradients of every group and of the means2d tap --------------------
    offset = jnp.zeros((128, 2))
    (loss_j, (psnr_j, dropped_j, clipped_j)), (grads_j, g2d_j) = jax.jit(
        jax.value_and_grad(lambda p, off: _loss_j(tj, p, off, frame), argnums=(0, 1),
                           has_aux=True, allow_int=True))(tj.params, offset)
    loss_t, aux_t, grads_t, g2d_t = tt.loss_and_grads(frame)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-6
    assert abs(float(aux_t["psnr"]) - float(psnr_j)) <= 1e-4
    for path, label, _ in t_optim.labelled_leaves(tt.params):
        if label == "frozen":
            continue
        a = t_optim.tree_get(grads_t, path).numpy()
        b = np.asarray(t_optim.tree_get(grads_j, path))
        scale = float(np.abs(b).max())
        assert scale > 0.0, path
        np.testing.assert_allclose(a, b, atol=1e-4 * scale, rtol=1e-3, err_msg=str(path))
    scale = float(np.abs(g2d_j).max())
    assert scale > 0.0
    np.testing.assert_allclose(g2d_t.numpy(), np.asarray(g2d_j), atol=1e-4 * scale, rtol=1e-3)

    # -- the step itself: scalars, ADC statistics, updated parameters -------
    out_j, out_t = tj.run_step(), tt.run_step()
    assert abs(out_t["loss"] - out_j["loss"]) <= 1e-6
    assert abs(out_t["loss"] - float(loss_j)) <= 1e-6
    assert abs(out_t["psnr"] - out_j["psnr"]) <= 1e-4
    assert out_t["dropped"] == out_j["dropped"] == float(dropped_j)
    assert out_t["clipped"] == out_j["clipped"] == float(clipped_j)
    np.testing.assert_array_equal(tt.adc.count.numpy(), np.asarray(tj.adc.count))
    assert int(tt.adc.count.sum()) > 0
    np.testing.assert_array_equal(tt.adc.max_radii.numpy(), np.asarray(tj.adc.max_radii))
    accum = np.asarray(tj.adc.grad_accum)
    np.testing.assert_allclose(tt.adc.grad_accum.numpy(), accum,
                               atol=1e-4 * float(accum.max()), rtol=1e-3)
    _check_params(tt, tj, np_params, 5e-3)
    assert tt.opt_state["count"] == 1 and tt.step == tj.step == 1


def test_five_steps_match_jax(trainers):
    """Runs after the one-step test on the same trainers: steps 2 to 5."""
    tj, tt, np_params = trainers
    while tj.step < 5:
        out_j, out_t = tj.run_step(), tt.run_step()
    assert tt.step == 5
    assert abs(out_t["loss"] - out_j["loss"]) <= 1e-3
    assert abs(out_t["psnr"] - out_j["psnr"]) <= 0.05
    _check_params(tt, tj, np_params, 2e-2)


# -- the port's counterparts of tests/test_train_smoke.py ---------------------


def tiny_cfg(**model_kw):
    cfg = _cfg(t_config, **model_kw)
    cfg.model.crf = t_config.CRFConfig(kind="identity")
    cfg.optim.pose_trans_lr_scale = 1.0
    cfg.loss.pose_anchor_weight = 0.0
    cfg.data.eval_every = 8
    return cfg


@pytest.fixture(scope="module")
def tiny_dataset():
    return t_dataset.make_synthetic_dataset(
        seed=3, n_gaussians=50, n_frames=4, n_virtual=2, size=20, device="cpu"
    )


def test_loss_decreases(tiny_dataset):
    t = TorchTrainer(tiny_cfg(), tiny_dataset, device="cpu")
    first = [t.run_step()["loss"] for _ in range(5)]
    for _ in range(30):
        last = t.run_step()
    assert last["loss"] < np.mean(first), (first, last)
    assert not t.params["gaussians"]["means"].requires_grad


def test_dense_knot_grid_trains(tiny_dataset):
    t = TorchTrainer(tiny_cfg(knots_per_frame=3), tiny_dataset, device="cpu")
    f = tiny_dataset.timestamps.shape[0]
    assert t.params["knot_deltas"].shape[0] == (f - 1) * 3 + 3 + 4 + 1
    first = [t.run_step()["loss"] for _ in range(5)]
    for _ in range(25):
        last = t.run_step()
    assert last["loss"] < np.mean(first), (first, last)


def test_coarse_to_fine_and_train_loop(tiny_dataset, tmp_path, capsys):
    """train() with the coarse-to-fine blur schedule: logs Mpix/s, evaluates
    on its interval, says that it saves no checkpoint."""
    cfg = tiny_cfg()
    cfg.loss.coarse_to_fine_steps = 4
    cfg.loss.coarse_sigma0 = 2.0
    cfg.optim.max_steps = 6
    cfg.log_every = 3
    cfg.eval_every = 6
    cfg.out_dir = str(tmp_path)
    t = TorchTrainer(cfg, tiny_dataset, device="cpu")
    assert t._c2f_sigma() == 2.0
    last = t.train()
    assert t.step == 6 and t._c2f_sigma() == 0.0 and np.isfinite(last["loss"])
    lines = (tmp_path / "parity" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 and "mpix_s" in lines[0] and "eval_psnr" in lines[2]
    assert "saves none" in capsys.readouterr().out


def test_shared_binning_self_guard(capsys):
    def build(shake):
        ds = t_dataset.make_synthetic_dataset(
            seed=5, n_gaussians=2000, n_frames=4, n_virtual=3, size=64,
            angle_span=0.2, exposure_range=(0.8, 1.0),
            scale_range=(0.005, 0.02), shake_rot=shake, shake_trans=shake / 6,
            device="cpu",
        )
        cfg = tiny_cfg(num_virtual_views=3, max_gaussians=2048)
        cfg.model.rasterize = t_config.RasterizeConfig(
            tile_h=8, tile_w=8, max_tiles_per_gaussian=16, chunk=32, packed=True,
            shared_binning=True, stream_factor=8,
        )
        return TorchTrainer(cfg, ds, device="cpu")

    t = build(shake=0.3)
    out = capsys.readouterr().out
    assert not t.cfg.model.rasterize.shared_binning
    assert "shared binning disabled" in out
    # ...and a becalmed fixture keeps shared binning on
    assert build(shake=0.0).cfg.model.rasterize.shared_binning


def test_footprint_budget_guard_warns_at_startup(capsys):
    ds = t_dataset.make_synthetic_dataset(
        seed=3, n_gaussians=60, n_frames=4, n_virtual=2, size=64, device="cpu"
    )
    cfg = tiny_cfg()
    cfg.model.rasterize = t_config.RasterizeConfig(
        tile_h=8, tile_w=8, max_tiles_per_gaussian=2, chunk=32)
    TorchTrainer(cfg, ds, device="cpu")
    out = capsys.readouterr().out
    assert "max_tiles_per_gaussian" in out and "INITIAL" in out
    # ...and a sufficient budget stays quiet
    cfg.model.rasterize = t_config.RasterizeConfig(
        tile_h=8, tile_w=8, max_tiles_per_gaussian=64, chunk=32)
    TorchTrainer(cfg, ds, device="cpu")
    assert "INITIAL" not in capsys.readouterr().out


def test_pose_anchor_pulls_deltas_to_init(tiny_dataset):
    cfg = tiny_cfg()
    cfg.loss.pose_anchor_weight = 10.0
    cfg.optim.pose_lr_init = 1e-2
    cfg.optim.pose_warmup_steps = 0
    t = TorchTrainer(cfg, tiny_dataset, device="cpu")
    t.params["knot_deltas"] = torch.full_like(t.params["knot_deltas"], 0.05)
    n0 = float(torch.linalg.norm(t.params["knot_deltas"]))
    for _ in range(10):
        t.run_step()
    n1 = float(torch.linalg.norm(t.params["knot_deltas"]))
    assert n1 < 0.5 * n0, (n0, n1)


def test_evaluate_returns_metrics(tiny_dataset):
    t = TorchTrainer(tiny_cfg(), tiny_dataset, device="cpu")
    m = t.evaluate()
    assert "eval_psnr" in m and np.isfinite(m["eval_psnr"])
    # frame 0 is held out (eval_every 8) and the fixture has sharp frames
    for key in ("eval_ssim", "eval_ms_ssim", "eval_novel_psnr", "eval_sharp_psnr",
                "eval_sharp_psnr_input"):
        assert np.isfinite(m[key]), key
    assert "eval_lpips" not in m
    assert set(t.evaluate(indices=[1])) >= {"eval_psnr", "eval_sharp_psnr"}


def test_watchdog_arms_screen_prune(tiny_dataset, capsys):
    t = TorchTrainer(tiny_cfg(), tiny_dataset, device="cpu")
    t._watch_overflow({"clipped": 0.0})
    assert not t._screen_prune_armed
    t._watch_overflow({"clipped": 1e6})
    assert t._screen_prune_armed and "clipped" in capsys.readouterr().out


@pytest.mark.parametrize("due,setup", [
    ("a densify round", dict(start_iter=1, interval=2)),
    ("a prune-only round", dict(start_iter=1, stop_iter=1, interval=2, screen_prune_from=1)),
    ("an opacity reset", dict(start_iter=100, opacity_reset_interval=2)),
])
def test_unported_rounds_raise(tiny_dataset, due, setup):
    """A density-control round that comes due after step 2 runs inside
    run_step, and leaves exactly what the same round applied by hand leaves
    on a twin trainer whose schedule holds no round."""
    def build(**densify_kw):
        cfg = tiny_cfg()
        cfg.densify.enabled = True
        cfg.densify.grad_threshold = 1e-7  # so that Gaussians do ask for slots
        for k, v in densify_kw.items():
            setattr(cfg.densify, k, v)
        return TorchTrainer(cfg, tiny_dataset, device="cpu")

    t = build(**setup)
    twin = build(start_iter=100, interval=10**6, opacity_reset_interval=10**6)
    assert t.active_sh_degree() == 0  # the SH warm-up of a density-controlled run
    for trainer in (t, twin):
        trainer.run_step()
    assert int(t.adc.count.sum()) > 0
    out, out_twin = t.run_step(), twin.run_step()
    assert not set(out_twin) & {"cloned", "split", "pruned", "alive"}
    d = t.cfg.densify
    g = twin.params["gaussians"]
    if due == "an opacity reset":
        g = t_densify.reset_opacity(g)
        assert set(out) == set(out_twin)
        assert float(t.params["gaussians"]["opacity_logit"].max()) <= np.log(0.01 / 0.99) + 1e-6
    else:
        prune_only = due == "a prune-only round"
        g, opt_state, adc, report = t_densify.densify_and_prune(
            g, twin.opt_state, twin.adc, torch.Generator().manual_seed(t.cfg.seed + 1),
            d, twin.scene_extent, twin._image_diag,
            screen_prune=prune_only, prune_only=prune_only)
        assert (out["cloned"], out["split"], out["pruned"], out["alive"]) == tuple(
            int(x) for x in report)
        assert out["alive"] == int(t.params["gaussians"]["alive"].sum())
        assert (out["cloned"] + out["split"] > 0) != prune_only
        assert int(t.adc.count.sum()) == 0  # the statistics start over
        for a, b in zip(t_optim.labelled_leaves(t.opt_state["mu"]),
                        t_optim.labelled_leaves(opt_state["mu"])):
            torch.testing.assert_close(a[2], b[2], rtol=0, atol=0)
    for k, v in t.params["gaussians"].items():
        torch.testing.assert_close(v, g[k], rtol=0, atol=0, msg=k)


def test_save_and_load_raise(tiny_dataset, tmp_path):
    t = TorchTrainer(tiny_cfg(), tiny_dataset, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t.save(str(tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t.load(str(tmp_path))
