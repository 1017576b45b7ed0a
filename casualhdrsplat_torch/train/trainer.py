"""Training orchestration on one device.  Counterpart of
casualhdrsplat_tpu/train/trainer.py.

One `run_step` spans the full differentiable chain: virtual-pose spline
sampling, HDR rasterization of all n virtual views in one compositor
launch, CRF tone-mapping, blur synthesis, photometric + prior losses, the
hand-written backward of the compositor, per-group Adam.  The screen-space
gradient statistics density control needs are taken from the
`means2d_offset` gradient tap: a zeros input added to the projected means,
so autograd surfaces d loss / d means2d without any bookkeeping in the
rasterizer.  A step reads the device once, for its four scalars (and the
four counts of a density-control round's report when one ran).

After the step, on the reference's schedule: a densify round in the
densify window, a prune-only round outside it while the screen-size prune
is armed, and the opacity reset (train/densify.py).

Not ported yet (ROADMAP.md, queue A): checkpoints (`save` and `load`
raise; `train` says so once and saves nothing) and LPIPS in `evaluate`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch

from casualhdrsplat_torch.config import TrainConfig
from casualhdrsplat_torch.data.dataset import Dataset, load_dataset
from casualhdrsplat_torch.models import crf as crf_mod
from casualhdrsplat_torch.models import gaussians as gauss_mod
from casualhdrsplat_torch.models import image_formation as imf
from casualhdrsplat_torch.models import losses
from casualhdrsplat_torch.ops.binning import tile_grid
from casualhdrsplat_torch.ops.projection import cull_invisible, project_gaussians
from casualhdrsplat_torch.train import densify as densify_mod
from casualhdrsplat_torch.train import metrics as metrics_mod
from casualhdrsplat_torch.train import optim as optim_mod

_NOT_PORTED = "not ported yet: ROADMAP.md, queue A, 'Checkpoints'"


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        dataset: Optional[Dataset] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dataset = dataset if dataset is not None else load_dataset(cfg.data, device)
        self.dataset.split(cfg.data.eval_every)
        self.scene = imf.build_scene(self.dataset, cfg.model, device=self.device)
        self.scene_extent = self.dataset.scene_extent()
        self.params = imf.init_params(
            self.scene,
            self.dataset.points_xyz,
            self.dataset.points_rgb,
            cfg.model,
            torch.Generator().manual_seed(cfg.seed),
        )
        self.opt = optim_mod.make_optimizer(cfg.optim, self.scene_extent)
        self.opt_state = self.opt.init(self.params)
        self.adc = densify_mod.AdcState.zero(cfg.model.max_gaussians, self.device)
        self._init_log_exposures = self.params["log_exposures"].clone()
        # oversized-splat watchdog state (_watch_overflow)
        self._clip_floor = float("inf")
        self._clip_warn_at = 0.0
        self._screen_prune_armed = False
        self._guard_shared_binning()
        self._guard_footprint_budget()
        # the frame stack lives on the device once
        self.images = torch.as_tensor(self.dataset.images, device=self.device)
        self.step = 0
        # the split noise of the density-control rounds (the reference seeds
        # its jax.random key the same way; the numbers differ)
        self._adc_generator = torch.Generator().manual_seed(cfg.seed + 1)
        # the reference's frame sequence: both trainers draw the same frames
        self._rng = np.random.default_rng(cfg.seed + 2)
        self.logger: Optional[metrics_mod.MetricsLogger] = None
        self._image_diag = float(np.hypot(self.dataset.width, self.dataset.height))

    def _guard_shared_binning(self) -> None:
        """Startup self-guard: shared binning's Chebyshev radius inflation
        can multiply binning demand past the stream budget when
        within-exposure motion is large; the run then silently waterfills
        away a large fraction of every step's contributions and the fit
        plateaus.  Measure the inflated demand on every frame before the
        first step and fall back to exact per-view binning, loudly, if it
        does not fit."""
        r = self.cfg.model.rasterize
        if not (r.packed and r.shared_binning
                and self.cfg.model.num_virtual_views > 1
                and self.cfg.model.optimize_poses):
            return
        # max over frames: within-exposure motion varies along the video
        shared = per_view = budget = 0
        with torch.no_grad():
            for f in range(self.dataset.timestamps.shape[0]):
                sh, pv, bud = imf.shared_binning_demand(
                    self.params, self.scene, f, self.cfg.model
                )
                shared, per_view = max(shared, int(sh)), max(per_view, int(pv))
                budget = int(bud)
        if shared <= budget:
            return
        if per_view <= budget:
            print(
                f"WARNING: shared binning disabled — motion-inflated "
                f"binning demand ({shared} rows) exceeds the stream "
                f"budget ({budget}); exact per-view binning fits "
                f"({per_view} rows/view) and is used instead. Raise "
                f"model.rasterize.stream_factor to keep shared binning "
                f"(docs/TUNING.md).",
                flush=True,
            )
            self.cfg.model.rasterize = dataclasses.replace(r, shared_binning=False)
        else:
            print(
                f"WARNING: binning demand exceeds the stream budget in "
                f"BOTH regimes (shared {shared}, per-view {per_view}, "
                f"budget {budget} rows) — training will waterfill-drop "
                f"contributions. Raise model.rasterize.stream_factor or "
                f"shrink footprints (docs/TUNING.md).",
                flush=True,
            )

    def _guard_footprint_budget(self) -> None:
        """Startup guard: if the initial scene already exceeds
        max_tiles_per_gaussian, the centre-clamp truncates visible coverage
        of splats the data requires; renders carry black bands, those
        splats' gradients are corrupted, and training enters a
        fatten-to-compensate runaway.  One projection pass at the first
        frame pose; loud warning when >0.1% of visible splats clip
        (docs/TUNING.md: 'clipped at step 0 is a correctness smell')."""
        r = self.cfg.model.rasterize
        with torch.no_grad():
            act = gauss_mod.activate(self.params["gaussians"])
            proj = cull_invisible(
                project_gaussians(
                    act.means3d, act.quats, act.scales,
                    torch.as_tensor(self.dataset.viewmats[0], device=self.device),
                    self.scene.fx, self.scene.fy, self.scene.cx, self.scene.cy,
                    self.scene.width, self.scene.height,
                    near_plane=r.near_plane, antialias=r.antialias,
                ),
                act.opacities,
            )
        m2 = proj.means2d.cpu().numpy()
        rad = proj.radii.cpu().numpy()
        val = proj.valid.cpu().numpy()
        ntx, nty = tile_grid(self.scene.width, self.scene.height, r.tile_h, r.tile_w)
        tx0 = np.clip(np.floor((m2[:, 0] - rad) / r.tile_w), 0, ntx - 1)
        tx1 = np.clip(np.floor((m2[:, 0] + rad) / r.tile_w), 0, ntx - 1)
        ty0 = np.clip(np.floor((m2[:, 1] - rad) / r.tile_h), 0, nty - 1)
        ty1 = np.clip(np.floor((m2[:, 1] + rad) / r.tile_h), 0, nty - 1)
        area = ((tx1 - tx0 + 1) * (ty1 - ty0 + 1))[val]
        n_vis = max(len(area), 1)
        n_over = int((area > r.max_tiles_per_gaussian).sum())
        if n_over > max(1, int(1e-3 * n_vis)):
            cut = int(np.maximum(area - r.max_tiles_per_gaussian, 0).sum())
            print(
                f"WARNING: {n_over}/{n_vis} visible splats of the INITIAL "
                f"scene exceed max_tiles_per_gaussian={r.max_tiles_per_gaussian} "
                f"({cut} bbox cells truncated at frame 0) — their visible "
                f"coverage will be cut and training can enter a fat-splat "
                f"runaway. Raise model.rasterize.max_tiles_per_gaussian "
                f"(docs/TUNING.md: 'clipped at step 0 is a correctness "
                f"smell').",
                flush=True,
            )

    # -- the step ------------------------------------------------------------

    def _c2f_sigma(self) -> float:
        """Coarse-to-fine blur sigma for the current step."""
        n = self.cfg.loss.coarse_to_fine_steps
        if n <= 0:
            return 0.0
        return float(self.cfg.loss.coarse_sigma0) * max(0.0, 1.0 - self.step / n)

    def _loss(self, p, offset, frame_id: int, blur_sigma, sh_degree: int):
        """The training objective on one frame: (loss, aux)."""
        cfg = self.cfg
        target = self.images[frame_id]
        out = imf.render_frame(
            p, self.scene, frame_id, cfg.model,
            sh_degree=sh_degree, means2d_offset=offset,
        )
        pred, tgt = out.blurred_ldr, target
        if cfg.loss.coarse_to_fine_steps > 0:
            # the kernel must cover ~3 sigma at the schedule's start
            k = int(3 * cfg.loss.coarse_sigma0) * 2 + 1
            pred = losses.gaussian_blur(pred, blur_sigma, k=k)
            tgt = losses.gaussian_blur(tgt, blur_sigma, k=k)
        photo = losses.photometric(pred, tgt, cfg.loss.ssim_lambda)
        loss = photo
        if cfg.loss.pose_anchor_weight > 0.0 and cfg.model.optimize_poses:
            # co-warp brake: pin the knot deltas to the SfM init
            kd = p["knot_deltas"]
            loss = loss + cfg.loss.pose_anchor_weight * torch.mean((kd * kd).sum(-1))
        if cfg.model.optimize_exposure:
            # gauge anchor at the init estimate (not log dt = 0: with
            # exposure_init_frac set, the init already encodes the
            # plausible-shutter prior)
            loss = loss + cfg.loss.exposure_prior_weight * losses.exposure_prior(
                p["log_exposures"], self._init_log_exposures
            )
        if cfg.model.crf.kind == "mlp":
            loss = loss + cfg.loss.crf_smoothness_weight * crf_mod.smoothness_prior(
                p["crf"], cfg.model.crf
            )
            if cfg.loss.crf_chroma_weight > 0.0:
                loss = loss + cfg.loss.crf_chroma_weight * crf_mod.chroma_prior(
                    p["crf"], cfg.model.crf
                )
        aux = {
            "photo": photo.detach(),
            "psnr": losses.psnr(out.blurred_ldr.detach(), target),
            "radii": out.aux.radii,
            "num_dropped": out.aux.num_dropped,
            "num_clipped": out.aux.num_clipped,
        }
        return loss, aux

    def loss_and_grads(self, frame_id: int, blur_sigma=0.0, sh_degree: Optional[int] = None):
        """Loss, aux, the gradient tree of every floating parameter leaf
        (zeros where the loss does not reach a leaf) and the gradient of
        the `means2d_offset` tap [N, 2]."""
        deg = self.active_sh_degree() if sh_degree is None else sh_degree
        paths, leaves = [], []
        p: Dict[str, object] = {"crf": {}}
        for path, label, leaf in optim_mod.labelled_leaves(self.params):
            if label != "frozen":
                leaf = leaf.detach().requires_grad_(True)
                paths.append(path)
                leaves.append(leaf)
            optim_mod.tree_set(p, path, leaf)
        offset = torch.zeros(
            (self.cfg.model.max_gaussians, 2), device=self.device, requires_grad=True
        )
        loss, aux = self._loss(p, offset, frame_id, blur_sigma, deg)
        found = torch.autograd.grad(loss, leaves + [offset], allow_unused=True)
        grads: Dict[str, object] = {"crf": {}}
        for path, leaf, grad in zip(paths, leaves, found):
            optim_mod.tree_set(grads, path, torch.zeros_like(leaf) if grad is None else grad)
        g2d = found[-1] if found[-1] is not None else torch.zeros_like(offset)
        return loss.detach(), aux, grads, g2d

    def _train_step(self, frame_id: int, blur_sigma, sh_degree: int) -> torch.Tensor:
        """Loss, backward, Adam on the floating leaves, ADC statistics.
        Returns one fused scalar vector [loss, psnr, dropped, clipped], so
        that run_step reads the device once."""
        loss, aux, grads, g2d = self.loss_and_grads(frame_id, blur_sigma, sh_degree)
        self.opt_state = self.opt.update(grads, self.opt_state, self.params)
        with torch.no_grad():
            self.adc = densify_mod.accumulate(
                self.adc, g2d, aux["radii"],
                image_size=(self.dataset.width, self.dataset.height),
            )
            return torch.stack([
                loss, aux["psnr"],
                torch.as_tensor(aux["num_dropped"], device=self.device).float(),
                torch.as_tensor(aux["num_clipped"], device=self.device).float(),
            ])

    # -- loop ----------------------------------------------------------------

    def active_sh_degree(self) -> int:
        if not self.cfg.densify.enabled:
            return self.cfg.model.sh_degree
        return min(
            self.step // self.cfg.densify.sh_degree_interval,
            self.cfg.model.sh_degree,
        )

    def _densify(self, screen_prune: bool, prune_only: bool = False):
        gauss, self.opt_state, self.adc, report = densify_mod.densify_and_prune(
            self.params["gaussians"], self.opt_state, self.adc, self._adc_generator,
            self.cfg.densify, self.scene_extent, self._image_diag,
            screen_prune=screen_prune, prune_only=prune_only,
        )
        self.params["gaussians"] = gauss
        return report

    def run_step(self) -> Dict[str, float]:
        frame = int(self._rng.choice(self.dataset.train_indices))
        sigma = self._c2f_sigma()
        if self.cfg.loss.coarse_to_fine_steps > 0:
            sigma = torch.tensor(sigma, device=self.device)
        scalars = self._train_step(frame, sigma, self.active_sh_degree())
        self.step += 1
        d = self.cfg.densify
        in_window = d.enabled and d.start_iter <= self.step <= d.stop_iter
        armed = self._screen_prune_armed or densify_mod.screen_prune_active(self.step, d)
        report = None
        if in_window and self.step % d.interval == 0:
            report = self._densify(armed)
        elif d.enabled and not in_window and armed and self.step % d.interval == 0:
            # Oversized-splat response outside the densify window: no
            # clone/split growth after densify.stop_iter, just screen-radius
            # pruning, whenever the screen prune is armed (by the clipped
            # watchdog or by densify.screen_prune_from).
            report = self._densify(True, prune_only=True)
        # Reset only while densification is active: the lineage stops at
        # stop_iter, else the final model could keep every opacity clamped
        # near-transparent.
        if d.enabled and self.step < d.stop_iter and self.step % d.opacity_reset_interval == 0:
            self.params["gaussians"] = densify_mod.reset_opacity(self.params["gaussians"])
        if report is not None:
            scalars = torch.cat([scalars, torch.stack(list(report)).to(scalars.dtype)])
        values = scalars.tolist()  # the one host read
        loss_v, psnr_v, dropped_v, clipped_v = values[:4]
        # binning-budget overflow is an approximation (far-tail drop per
        # tile): surfaced so a blown budget is never silent
        out = {"loss": loss_v, "psnr": psnr_v, "dropped": dropped_v, "clipped": clipped_v}
        if report is not None:
            out.update(zip(("cloned", "split", "pruned", "alive"), map(int, values[4:])))
        self._watch_overflow(out)
        return out

    def _n_streams(self) -> int:
        """Streams binned per frame: one with shared binning, else one per
        virtual view."""
        r = self.cfg.model.rasterize
        if r.packed and r.shared_binning and self.cfg.model.num_virtual_views > 1:
            return 1
        return self.cfg.model.num_virtual_views

    def _watch_overflow(self, out: Dict[str, float]) -> None:
        """Oversized-splat watchdog: `clipped` (bbox cells cut by the
        max_tiles_per_gaussian clamp) is the on-device symptom of splats
        blowing past their binning footprint.  Warn (once per doubling)
        when it rises well past its observed floor and a meaningful
        fraction of the bbox budget, and arm the screen-size prune."""
        clipped = out["clipped"]
        self._clip_floor = min(self._clip_floor, clipped)
        r = self.cfg.model.rasterize
        budget = float(
            r.max_tiles_per_gaussian * self.cfg.model.max_gaussians * self._n_streams()
        )
        trigger = max(3.0 * self._clip_floor, 0.02 * budget, self._clip_warn_at)
        if clipped > trigger:
            print(
                f"WARNING step {self.step}: {clipped:.0f} bbox cells "
                f"clipped by the max_tiles_per_gaussian clamp "
                f"({clipped / budget:.1%} of the bbox budget, floor was "
                f"{self._clip_floor:.0f}) — splats are outgrowing their "
                f"binning footprint; arming the automatic screen-size "
                f"prune (densify.prune_screen_radius="
                f"{self.cfg.densify.prune_screen_radius}). See "
                f"docs/TUNING.md.",
                flush=True,
            )
            self._clip_warn_at = 2.0 * clipped
            self._screen_prune_armed = True

    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        out_dir = os.path.join(cfg.out_dir, cfg.name)
        self.logger = self.logger or metrics_mod.MetricsLogger(out_dir)
        print(f"NOTE: checkpoints are {_NOT_PORTED}; this run saves none.", flush=True)
        timer = metrics_mod.Timer()
        last: Dict[str, float] = {}
        # Persistent stream-budget overflow corrupts gradients (the fit
        # plateaus; docs/TUNING.md): make it loud, once.
        r = cfg.model.rasterize
        stream_budget = (
            min(r.stream_factor, r.max_tiles_per_gaussian)
            * cfg.model.max_gaussians
            * self._n_streams()
        )
        overflow_warned = False
        while self.step < cfg.optim.max_steps:
            last = self.run_step()
            if not overflow_warned and last["dropped"] > 0.05 * stream_budget:
                print(
                    f"WARNING step {self.step}: {last['dropped']:.0f} "
                    f"intersections dropped (> 5% of the "
                    f"{stream_budget}-row stream budget). Training "
                    "gradients are being truncated — raise "
                    "model.rasterize.stream_factor or reduce footprint "
                    "demand (docs/TUNING.md).",
                    flush=True,
                )
                overflow_warned = True
            if self.step % cfg.log_every == 0:
                dt = timer.lap()
                mpix = (
                    cfg.log_every
                    * self.dataset.width
                    * self.dataset.height
                    * cfg.model.num_virtual_views
                    / max(dt, 1e-9)
                    / 1e6
                )
                self.logger.log(self.step, mpix_s=mpix, **last)
            if cfg.eval_every and self.step % cfg.eval_every == 0:
                self.logger.log(self.step, **self.evaluate())
        return last

    # -- eval / io -----------------------------------------------------------

    @staticmethod
    def _metric_vector(pred, target):
        """[psnr, ssim, ms_ssim] in one host read."""
        return torch.stack([
            losses.psnr(pred, target),
            losses.ssim(pred, target),
            losses.ms_ssim(pred, target),
        ]).tolist()

    @torch.no_grad()
    def evaluate(self, indices=None) -> Dict[str, float]:
        """Score the model on held-out frames.

        Always: PSNR/SSIM/MS-SSIM of the synthesized blurred frame B_i
        against the captured frame.  When the dataset carries ground-truth
        sharp frames (synthetic fixtures), additionally the deblurred
        mid-exposure render against sharp GT (`eval_sharp_psnr`) beside the
        captured blurry input's own PSNR against sharp GT
        (`eval_sharp_psnr_input`): the deblurring gain is their gap."""
        idx = indices if indices is not None else self.dataset.eval_indices
        if len(idx) == 0:
            idx = self.dataset.train_indices[:2]
        deg = self.active_sh_degree()
        cfg = self.cfg.model
        blurred, sharp, sharp_in = [], [], []
        sharp_gt = self.dataset.sharp_images
        for i in idx:
            fid = int(i)
            out = imf.render_frame(self.params, self.scene, fid, cfg, sh_degree=deg)
            target = self.images[fid]
            blurred.append(self._metric_vector(out.blurred_ldr, target))
            if sharp_gt is not None:
                gt = torch.as_tensor(sharp_gt[fid], device=self.device)
                deb, _, _ = imf.render_deblurred(self.params, self.scene, fid, cfg,
                                                 sh_degree=deg)
                sharp.append(self._metric_vector(deb, gt))
                sharp_in.append(float(losses.psnr(target, gt)))
        psnr_v, ssim_v, ms_v = np.mean(blurred, axis=0)
        metrics = {"eval_psnr": float(psnr_v), "eval_ssim": float(ssim_v),
                   "eval_ms_ssim": float(ms_v)}
        # True held-out novel-view eval: frames excluded from training,
        # rendered at the spline pose with an exposure interpolated from
        # neighbouring train frames, scored against GT sharp frames.
        if (
            indices is None
            and len(self.dataset.eval_indices) > 0
            and len(self.dataset.train_indices) > 0
            and sharp_gt is not None
        ):
            novel = []
            for i in self.dataset.eval_indices:
                log_e = imf.interpolated_log_exposure(
                    self.params, self.dataset.timestamps,
                    self.dataset.train_indices, int(i),
                )
                ldr, _, _ = imf.render_deblurred(
                    self.params, self.scene, int(i), cfg, sh_degree=deg,
                    exposure=torch.tensor(float(np.exp(log_e)), device=self.device),
                )
                gt = torch.as_tensor(sharp_gt[int(i)], device=self.device)
                novel.append(self._metric_vector(ldr, gt))
            metrics["eval_novel_psnr"] = float(np.mean([m[0] for m in novel]))
            metrics["eval_novel_ssim"] = float(np.mean([m[1] for m in novel]))
        if sharp:
            spsnr, sssim, sms = np.mean(sharp, axis=0)
            metrics["eval_sharp_psnr"] = float(spsnr)
            metrics["eval_sharp_ssim"] = float(sssim)
            metrics["eval_sharp_ms_ssim"] = float(sms)
            metrics["eval_sharp_psnr_input"] = float(np.mean(sharp_in))
        return metrics

    def save(self, out_dir: str) -> str:
        raise NotImplementedError(f"Trainer.save: checkpoints are {_NOT_PORTED}")

    def load(self, path: str) -> None:
        raise NotImplementedError(f"Trainer.load: checkpoints are {_NOT_PORTED}")
