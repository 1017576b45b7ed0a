"""Training orchestration, on one device or on a (data, gauss) mesh.
Counterpart of casualhdrsplat_tpu/train/trainer.py.

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

On a mesh (parallel/: `cfg.parallel.data * cfg.parallel.gauss > 1`, or a
mesh handed in) every rank runs the same step on its block of the store:
the frame render goes through parallel/render.py, Adam updates the blocks
and the replicated leaves alike, density control runs on each block
(`densify_and_prune_sharded`) and is followed by `_maybe_rebalance`.  Every
rank draws the same frames and reads its scalars in the same order, so the
collectives meet.

On a CUDA device the step (loss, backward, Adam, the ADC statistics and
the scalar stack) replays as one captured CUDA graph, the counterpart of
the reference's jitted `_train_step` (utils/cuda_graphs.py): one graph per
static key (the SH degree, the configs it bakes in, the mesh), its
numbers that change from step to step (the frame, the coarse-to-fine
sigma, the update count) read from device buffers filled before each
replay.  On a mesh only when every process group is NCCL (its collectives
are captured with the step; a replay adds their calls and bytes to
`mesh.stats`): gloo cannot be captured, so the CPU worlds and ranks that
share one card step eagerly (`cuda_graphs.graphable`).  The first step of
a key runs eagerly (the warm-up), the second captures.  A density-control
round and the rebalance, programs of their own in the reference, replay
graphs of their own between the step's replays (the round's static key:
its two switches and the host numbers its body bakes in; its split noise
drawn on the host into a static buffer first, `densify.SplitNoise`); the
opacity reset runs eagerly.  Each writes the store, its moments and
statistics in place, so the step's graph keeps reading the tensors it was
captured with; anything that rebinds them (`load`, a caller's assignment)
makes the next step capture again.  `run_step_eager` is the same step,
round and rebalance without a graph: the yardstick, and the path on the
CPU and on a gloo mesh.  `evaluate` replays the reference's evaluation
programs likewise (`renders`), one host read per evaluated frame.

`save` writes the reference's checkpoint payload plus what a continuation
needs to match an uninterrupted run bit for bit, which the reference
redraws from its seed instead: the split-noise generator, the frame
sampler and the oversized-splat watchdog.  `lock` is held across a step,
so that a reader on another thread (the viewer) never sees parameters
that Adam is halfway through writing in place.  `renders` serves
`render_pose` (the viewer, the command line) as CUDA graphs on the card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from casualhdrsplat_torch import config as config_mod
from casualhdrsplat_torch.config import TrainConfig
from casualhdrsplat_torch.data.dataset import Dataset, load_dataset
from casualhdrsplat_torch.models import crf as crf_mod
from casualhdrsplat_torch.models import gaussians as gauss_mod
from casualhdrsplat_torch.models import image_formation as imf
from casualhdrsplat_torch.models import losses
from casualhdrsplat_torch.models import perceptual
from casualhdrsplat_torch.ops.binning import tile_grid
from casualhdrsplat_torch.ops.projection import cull_invisible, project_gaussians
from casualhdrsplat_torch.parallel import collectives
from casualhdrsplat_torch.parallel import mesh as mesh_mod
from casualhdrsplat_torch.parallel import render as prender
from casualhdrsplat_torch.parallel import sharding
from casualhdrsplat_torch.parallel.mesh import GAUSS_AXIS
from casualhdrsplat_torch.train import checkpoint as ckpt_mod
from casualhdrsplat_torch.train import densify as densify_mod
from casualhdrsplat_torch.train import metrics as metrics_mod
from casualhdrsplat_torch.train import optim as optim_mod
from casualhdrsplat_torch.utils import cuda_graphs


class Trainer:
    def __init__(
        self,
        cfg: TrainConfig,
        dataset: Optional[Dataset] = None,
        device="cuda",
        mesh=None,
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
        # Mesh-parallel when the parallel config asks for more than one
        # device, or when the caller hands a mesh (of any shape): the store,
        # its moments and statistics lie in blocks over `gauss`, the step
        # renders through parallel/render.py.
        self.mesh = mesh
        if self.mesh is None and cfg.parallel.data * cfg.parallel.gauss > 1:
            self.mesh = mesh_mod.make_mesh(cfg.parallel)
        # logs, prints and checkpoint files come from one rank
        self.lead = self.mesh is None or self.mesh.rank == 0
        if self.mesh is not None:
            # every rank starts from rank 0's parameters
            sharding.broadcast_tree(self.params, self.mesh)
        self._guard_shared_binning()
        self._guard_footprint_budget()
        if self.mesh is not None:
            self.params = sharding.shard_params(self.params, self.mesh)
        self.opt = optim_mod.make_optimizer(cfg.optim, self.scene_extent)
        self.opt_state = self.opt.init(self.params)
        self.adc = densify_mod.AdcState.zero(self._capacity(), self.device)
        self._init_log_exposures = self.params["log_exposures"].clone()
        # oversized-splat watchdog state (_watch_overflow)
        self._clip_floor = float("inf")
        self._clip_warn_at = 0.0
        self._screen_prune_armed = False
        # the frame stack lives on the device once
        self.images = torch.as_tensor(self.dataset.images, device=self.device)
        self.step = 0
        # the split noise of the density-control rounds (the reference seeds
        # its jax.random key the same way; the numbers differ); on a mesh one
        # generator per block, seeded by (seed, block): the counterpart of
        # the reference's fold_in(key, g)
        self._adc_generator = torch.Generator().manual_seed(self._adc_seed())
        # the reference's frame sequence: both trainers, and every rank,
        # draw the same frames
        self._rng = np.random.default_rng(cfg.seed + 2)
        self.logger: Optional[metrics_mod.MetricsLogger] = None
        self._image_diag = float(np.hypot(self.dataset.width, self.dataset.height))
        self.lock = threading.Lock()
        # the step's inputs that change from step to step, as device
        # buffers (the reference's traced frame_id and blur_sigma)
        self._frame_buf = torch.zeros((), dtype=torch.int64, device=self.device)
        self._sigma_buf = torch.zeros((), dtype=torch.float32, device=self.device)
        self._adc_scale = densify_mod.grad_scale((self.dataset.width, self.dataset.height),
                                                 self.device)
        self._step_graphs = cuda_graphs.GraphCache()
        self._round_graphs = cuda_graphs.GraphCache()
        self._rebalance_graphs = cuda_graphs.GraphCache()
        self._noise: Optional[densify_mod.SplitNoise] = None
        self._sharp: Optional[torch.Tensor] = None
        self.renders = imf.GraphedRenders()

    def _capacity(self) -> int:
        """Slots this trainer holds: the store, or its block on a mesh."""
        return self.params["gaussians"]["alive"].shape[0]

    def _adc_seed(self) -> int:
        if self.mesh is None:
            return self.cfg.seed + 1
        g = self.mesh.axis_index(GAUSS_AXIS)
        return int(np.random.SeedSequence((self.cfg.seed + 1, g)).generate_state(1)[0])

    def _print(self, msg: str) -> None:
        if self.lead:
            print(msg, flush=True)

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
            self._print(
                f"WARNING: shared binning disabled — motion-inflated "
                f"binning demand ({shared} rows) exceeds the stream "
                f"budget ({budget}); exact per-view binning fits "
                f"({per_view} rows/view) and is used instead. Raise "
                f"model.rasterize.stream_factor to keep shared binning "
                f"(docs/TUNING.md)."
            )
            self.cfg.model.rasterize = dataclasses.replace(r, shared_binning=False)
        else:
            self._print(
                f"WARNING: binning demand exceeds the stream budget in "
                f"BOTH regimes (shared {shared}, per-view {per_view}, "
                f"budget {budget} rows) — training will waterfill-drop "
                f"contributions. Raise model.rasterize.stream_factor or "
                f"shrink footprints (docs/TUNING.md)."
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
            self._print(
                f"WARNING: {n_over}/{n_vis} visible splats of the INITIAL "
                f"scene exceed max_tiles_per_gaussian={r.max_tiles_per_gaussian} "
                f"({cut} bbox cells truncated at frame 0) — their visible "
                f"coverage will be cut and training can enter a fat-splat "
                f"runaway. Raise model.rasterize.max_tiles_per_gaussian "
                f"(docs/TUNING.md: 'clipped at step 0 is a correctness "
                f"smell')."
            )

    # -- the step ------------------------------------------------------------

    def _c2f_sigma(self) -> float:
        """Coarse-to-fine blur sigma for the current step."""
        n = self.cfg.loss.coarse_to_fine_steps
        if n <= 0:
            return 0.0
        return float(self.cfg.loss.coarse_sigma0) * max(0.0, 1.0 - self.step / n)

    def _render_frame(self, p, frame_id: int, sh_degree: int, offset=None):
        if self.mesh is not None:
            return prender.render_frame_sharded(p, self.scene, frame_id, self.cfg.model,
                                                self.mesh, sh_degree=sh_degree,
                                                means2d_offset=offset)
        return imf.render_frame(p, self.scene, frame_id, self.cfg.model, sh_degree=sh_degree,
                                means2d_offset=offset)

    def _loss(self, p, offset, frame_id, blur_sigma, sh_degree: int):
        """The training objective on one frame: (loss, aux)."""
        cfg = self.cfg
        target = imf.frame_entry(self.images, frame_id)
        out = self._render_frame(p, frame_id, sh_degree, offset)
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
        offset = torch.zeros((self._capacity(), 2), device=self.device, requires_grad=True)
        loss, aux = self._loss(p, offset, frame_id, blur_sigma, deg)
        found = torch.autograd.grad(loss, leaves + [offset], allow_unused=True)
        grads: Dict[str, object] = {"crf": {}}
        for path, leaf, grad in zip(paths, leaves, found):
            optim_mod.tree_set(grads, path, torch.zeros_like(leaf) if grad is None else grad)
        g2d = found[-1] if found[-1] is not None else torch.zeros_like(offset)
        return loss.detach(), aux, grads, g2d

    def _train_step(self, frame_id, blur_sigma, sh_degree: int) -> torch.Tensor:
        """Loss, backward, Adam on the floating leaves (at the optimizer's
        device count), ADC statistics, written in place.  Returns one fused
        scalar vector [loss, psnr, dropped, clipped], so that run_step reads
        the device once.  With `frame_id` and `blur_sigma` device tensors
        it makes no host read: the body of the captured step."""
        loss, aux, grads, g2d = self.loss_and_grads(frame_id, blur_sigma, sh_degree)
        self.opt.apply(grads, self.opt_state, self.params, self.opt.count_buffer(self.device))
        radii = aux["radii"]
        if self.mesh is not None:  # the projection of the whole store: this block's
            radii = radii[:, sharding.block(radii.shape[1], self.mesh)]
        with torch.no_grad():
            adc = densify_mod.accumulate(self.adc, g2d, radii, scale=self._adc_scale)
            for dst, src in zip(self.adc, adc):
                dst.copy_(src)
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

    def _densify(self, screen_prune: bool, prune_only: bool = False, graphed: bool = True):
        """One density-control round, written in place: its AdcReport of
        device scalars.  Its split noise is drawn into the static buffer
        first (the draws `densify_and_prune` would make); then on a
        graphable device a replay of the round's graph, else the round
        eagerly: the same result."""
        if self._noise is None:
            self._noise = densify_mod.SplitNoise(self._capacity(), self.device)
        self._noise.draw(self._adc_generator)
        if graphed and cuda_graphs.graphable(self.device, self.mesh):
            # every host number the round bakes in
            key = (screen_prune, prune_only, self.scene_extent, self._image_diag,
                   repr(self.cfg.densify), id(self.mesh))
            call = self._round_graphs.get(
                key, (*self._step_tensors(), self._noise.buffer),
                lambda: cuda_graphs.GraphedCall(
                    lambda: self._round(screen_prune, prune_only),
                    f"the density-control round (screen_prune {screen_prune}, prune_only "
                    f"{prune_only})",
                    capture_error_mode="global" if self.mesh is None else "thread_local"))
            report = call().clone()  # the next replay overwrites the graph's
        else:
            report = self._round(screen_prune, prune_only)
        return densify_mod.AdcReport(*report.unbind())

    def _round(self, screen_prune: bool, prune_only: bool) -> torch.Tensor:
        """The round on the noise in the static buffer, written in place
        (the body of the captured round): its report stacked [4]."""
        eps = self._noise.buffer
        args = (self.params["gaussians"], self.opt_state, self.adc, eps[0], eps[1],
                self.cfg.densify, self.scene_extent, self._image_diag)
        if self.mesh is not None:
            gauss, opt_state, adc, report = densify_mod.densify_and_prune_sharded_with_noise(
                *args, self.mesh, screen_prune=screen_prune, prune_only=prune_only)
        else:
            gauss, opt_state, adc, report = densify_mod.densify_and_prune_with_noise(
                *args, screen_prune=screen_prune, prune_only=prune_only)
        self._write_state(gauss, opt_state, adc)
        return torch.stack(list(report))

    @torch.no_grad()
    def _write_state(self, gauss, opt_state=None, adc=None) -> None:
        """Write a round's store (and moments, statistics) into the tensors
        the trainer holds, in place: a captured step keeps reading them."""
        trees = [(self.params["gaussians"], gauss)]
        if opt_state is not None:
            trees += [(self.opt_state[m]["gaussians"], opt_state[m]["gaussians"])
                      for m in ("mu", "nu")]
        for tree, new in trees:
            for k, v in new.items():
                if tree[k] is not v:
                    tree[k].copy_(v)
        if adc is not None:
            for dst, src in zip(self.adc, adc):
                if dst is not src:
                    dst.copy_(src)

    def _shard_counts(self) -> np.ndarray:
        """Alive Gaussians of every block, the same on every rank."""
        alive = sharding.gather_leaf(self.params["gaussians"]["alive"], self.mesh, "alive")
        return densify_mod.shard_alive_counts(alive, self.mesh.size(GAUSS_AXIS)).cpu().numpy()

    def _rebalance(self, graphed: bool = True) -> None:
        """Repack the store evenly over the blocks, in place: on a mesh whose
        groups are all NCCL a replay of its graph (its all-gathers inside),
        else eagerly."""
        if graphed and cuda_graphs.graphable(self.device, self.mesh):
            self._rebalance_graphs.get(
                id(self.mesh), self._step_tensors(),
                lambda: cuda_graphs.GraphedCall(self._rebalance_body, "the rebalance",
                                                capture_error_mode="thread_local"))()
        else:
            self._rebalance_body()

    def _rebalance_body(self) -> None:
        self._write_state(*densify_mod.rebalance_store(
            self.params["gaussians"], self.opt_state, self.adc,
            self.mesh.size(GAUSS_AXIS), mesh=self.mesh))

    def _maybe_rebalance(self, graphed: bool = True) -> bool:
        """After a sharded density-control round: repack the store across
        the blocks when their alive counts drifted apart by more than the
        configured share of a block.  Every rank decides on the same
        all-gathered counts, so all take the same branch."""
        thr = self.cfg.densify.rebalance_threshold
        if self.mesh is None or thr <= 0 or self.mesh.size(GAUSS_AXIS) <= 1:
            return False
        counts = self._shard_counts()
        if counts.max() - counts.min() <= thr * self._capacity():
            return False
        self._rebalance(graphed)
        return True

    def run_step(self) -> Dict[str, float]:
        """One training step: on a CUDA device (on a mesh, one whose groups
        are all NCCL) a replay of the captured step, elsewhere the eager
        step."""
        with self.lock:
            return self._run_step(graphed=True)

    def run_step_eager(self) -> Dict[str, float]:
        """One training step through the eager functions: the yardstick of
        the graphed step, from the same state the same result."""
        with self.lock:
            return self._run_step(graphed=False)

    def _step_tensors(self):
        """Every tensor the step reads or writes, in a fixed order: a
        captured step is valid while these are the same objects."""
        live = [leaf for _, _, leaf in optim_mod.labelled_leaves(self.params)]
        for moment in ("mu", "nu"):
            live += [optim_mod.tree_get(self.opt_state[moment], path)
                     for path, label, _ in optim_mod.labelled_leaves(self.params)
                     if label != "frozen"]
        scene = [getattr(self.scene, f.name) for f in dataclasses.fields(self.scene)]
        return (*live, *self.adc, *(t for t in scene if isinstance(t, torch.Tensor)),
                self.images, self._init_log_exposures)

    def _graphed_step(self, sh_degree: int) -> torch.Tensor:
        """The step's scalars from a replay of its graph for this key
        (captured on the key's second step, after an eager warm-up).  On a
        mesh the capture lets other threads use the card: NCCL's watchdog
        queries its events meanwhile."""
        key = (sh_degree, repr(self.cfg.model), repr(self.cfg.loss), id(self.opt),
               id(self.mesh))
        call = self._step_graphs.get(key, self._step_tensors(), lambda: cuda_graphs.GraphedCall(
            lambda: self._train_step(self._frame_buf, self._sigma_buf, sh_degree),
            f"the training step (SH degree {sh_degree})",
            capture_error_mode="global" if self.mesh is None else "thread_local"))
        return call()

    def _run_step(self, graphed: bool) -> Dict[str, float]:
        frame = int(self._rng.choice(self.dataset.train_indices))
        sigma = self._c2f_sigma()
        deg = self.active_sh_degree()
        self.opt.count_buffer(self.device).fill_(self.opt_state["count"])
        self._frame_buf.fill_(frame)
        self._sigma_buf.fill_(sigma)
        if graphed and cuda_graphs.graphable(self.device, self.mesh):
            scalars = self._graphed_step(deg)
        else:
            scalars = self._train_step(self._frame_buf, self._sigma_buf, deg)
        self.opt_state["count"] += 1
        self.step += 1
        d = self.cfg.densify
        in_window = d.enabled and d.start_iter <= self.step <= d.stop_iter
        armed = self._screen_prune_armed or densify_mod.screen_prune_active(self.step, d)
        report = None
        if in_window and self.step % d.interval == 0:
            report = self._densify(armed, graphed=graphed)
            self._maybe_rebalance(graphed)
        elif d.enabled and not in_window and armed and self.step % d.interval == 0:
            # Oversized-splat response outside the densify window: no
            # clone/split growth after densify.stop_iter, just screen-radius
            # pruning, whenever the screen prune is armed (by the clipped
            # watchdog or by densify.screen_prune_from).
            report = self._densify(True, prune_only=True, graphed=graphed)
        # Reset only while densification is active: the lineage stops at
        # stop_iter, else the final model could keep every opacity clamped
        # near-transparent.
        if d.enabled and self.step < d.stop_iter and self.step % d.opacity_reset_interval == 0:
            self._write_state(densify_mod.reset_opacity(self.params["gaussians"]))
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
            self._print(
                f"WARNING step {self.step}: {clipped:.0f} bbox cells "
                f"clipped by the max_tiles_per_gaussian clamp "
                f"({clipped / budget:.1%} of the bbox budget, floor was "
                f"{self._clip_floor:.0f}) — splats are outgrowing their "
                f"binning footprint; arming the automatic screen-size "
                f"prune (densify.prune_screen_radius="
                f"{self.cfg.densify.prune_screen_radius}). See "
                f"docs/TUNING.md."
            )
            self._clip_warn_at = 2.0 * clipped
            self._screen_prune_armed = True

    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        out_dir = os.path.join(cfg.out_dir, cfg.name)
        if self.lead:
            self.logger = self.logger or metrics_mod.MetricsLogger(out_dir)
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
                self._print(
                    f"WARNING step {self.step}: {last['dropped']:.0f} "
                    f"intersections dropped (> 5% of the "
                    f"{stream_budget}-row stream budget). Training "
                    "gradients are being truncated — raise "
                    "model.rasterize.stream_factor or reduce footprint "
                    "demand (docs/TUNING.md)."
                )
                overflow_warned = True
            if self.step % cfg.log_every == 0 and self.lead:
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
                metrics = self.evaluate()  # on every rank: its renders are collective
                if self.lead:
                    self.logger.log(self.step, **metrics)
            if cfg.checkpoint_every and self.step % cfg.checkpoint_every == 0:
                self.save(out_dir)
        self.save(out_dir)
        return last

    # -- eval / io -----------------------------------------------------------

    def _sharp_stack(self) -> torch.Tensor:
        """The dataset's sharp ground-truth frames on the device, once."""
        if self._sharp is None:
            self._sharp = torch.as_tensor(self.dataset.sharp_images, device=self.device)
        return self._sharp

    @torch.no_grad()
    def evaluate(self, indices=None, graphed: bool = True) -> Dict[str, float]:
        """Score the model on held-out frames.

        Always: PSNR/SSIM/MS-SSIM (and LPIPS when models/perceptual.py
        can run it) of the synthesized blurred frame B_i against the
        captured frame.  When the dataset carries ground-truth
        sharp frames (synthetic fixtures), additionally the deblurred
        mid-exposure render against sharp GT (`eval_sharp_psnr`) beside the
        captured blurry input's own PSNR against sharp GT
        (`eval_sharp_psnr_input`): the deblurring gain is their gap.

        Each render and its metric vector is one call of `renders` (on a
        CUDA device, and on a mesh whose groups are all NCCL, a replay of
        its graph: the reference's jitted eval renders and
        `_metric_vector`); a frame's vectors are read in one host read, and
        the learned exposures once for the novel views.  `graphed=False`
        runs the same functions eagerly: the yardstick, equal to the bit."""
        idx = indices if indices is not None else self.dataset.eval_indices
        if len(idx) == 0:
            idx = self.dataset.train_indices[:2]
        deg = self.active_sh_degree()
        cfg = self.cfg.model
        sharp_gt = self.dataset.sharp_images
        # True held-out novel-view eval: frames excluded from training,
        # rendered at the spline pose with an exposure interpolated from
        # neighbouring train frames, scored against GT sharp frames.  Then
        # `idx` is the held-out frames.
        novel = (indices is None and len(self.dataset.eval_indices) > 0
                 and len(self.dataset.train_indices) > 0 and sharp_gt is not None)
        # on a mesh the deblurred renders gather the store, inside their graphs
        renders = self.renders if graphed else imf
        # one host read of the learned exposures for all novel views
        log_exposures = ({"log_exposures": self.params["log_exposures"].cpu().numpy()}
                         if novel else None)
        rows, lpips_vals = [], []
        for i in idx:
            fid = int(i)
            blurred, parts = renders.frame_scores(self.params, self.scene, fid, cfg, self.images,
                                                  deg, self.mesh)
            parts = [parts]
            if perceptual.available():
                lpips_vals.append(perceptual.lpips(blurred.cpu().numpy(),
                                                   self.images[fid].cpu().numpy()))
            if sharp_gt is not None:
                # [psnr, ssim, ms_ssim] of the deblurred view, the input's psnr
                parts.append(renders.deblurred_scores(self.params, self.scene, fid, cfg, False,
                                                      deg, None, self._sharp_stack(),
                                                      self.images, self.mesh)[1])
            if novel:
                log_e = imf.interpolated_log_exposure(log_exposures, self.dataset.timestamps,
                                                      self.dataset.train_indices, fid)
                parts.append(renders.deblurred_scores(
                    self.params, self.scene, fid, cfg, False, deg, float(np.exp(log_e)),
                    self._sharp_stack(), None, self.mesh)[1])
            rows.append(torch.cat(parts).tolist())  # the frame's one host read
        rows = np.asarray(rows)
        psnr_v, ssim_v, ms_v = rows[:, 0:3].mean(axis=0)
        metrics = {"eval_psnr": float(psnr_v), "eval_ssim": float(ssim_v),
                   "eval_ms_ssim": float(ms_v)}
        if novel:
            metrics["eval_novel_psnr"] = float(np.mean(rows[:, 7]))
            metrics["eval_novel_ssim"] = float(np.mean(rows[:, 8]))
        if lpips_vals:
            metrics["eval_lpips"] = float(np.mean(lpips_vals))
        if sharp_gt is not None:
            spsnr, sssim, sms, sin = rows[:, 3:7].mean(axis=0)
            metrics["eval_sharp_psnr"] = float(spsnr)
            metrics["eval_sharp_ssim"] = float(sssim)
            metrics["eval_sharp_ms_ssim"] = float(sms)
            metrics["eval_sharp_psnr_input"] = float(sin)
        return metrics

    def save(self, out_dir: str) -> str:
        """Write the checkpoint `out_dir/step_<step>` and, beside it, the
        resolved config as `config.json` (rewritten on every save, through
        a temporary file, so that a stale or truncated one never stays).
        Returns the checkpoint's path.

        On a mesh every rank calls it: the `gauss` ranks gather the store,
        its moments and statistics, and rank 0 writes the one-device
        format, so either kind of trainer loads what either wrote.  The
        blocks' split-noise generators go under `resume.adc_generators`,
        block 0's also where the one-device trainer keeps its own."""
        out_abs = os.path.abspath(out_dir)
        path = os.path.join(out_abs, f"step_{self.step}")
        params, opt_state, adc = self.params, self.opt_state, self.adc
        generators = [self._adc_generator.get_state()]
        if self.mesh is not None:
            params = sharding.gather_params(params, self.mesh)
            opt_state = sharding.gather_opt_state(opt_state, self.mesh)
            adc = densify_mod.AdcState(*(sharding.gather_leaf(x, self.mesh) for x in adc))
            generators = [s.cpu() for s in collectives.all_gather(
                generators[0].to(self.device), self.mesh, GAUSS_AXIS, "gather_state")]
        resume = {
            # beyond the reference's payload: the state a continuation
            # needs to draw what an uninterrupted run would have drawn
            "adc_generator": generators[0],
            "rng": self._rng.bit_generator.state,
            "clip_floor": self._clip_floor,
            "clip_warn_at": self._clip_warn_at,
            "screen_prune_armed": self._screen_prune_armed,
        }
        if self.mesh is not None:
            resume["adc_generators"] = generators
        if self.lead:
            ckpt_mod.save(path, {"params": params, "opt_state": opt_state,
                                 "adc": adc._asdict(), "step": self.step, "resume": resume})
            # The parameter and optimizer trees depend on the config (CRF
            # kind, capacity, ...): render, eval and export rebuild it from
            # this file.
            cfg_path = os.path.join(out_abs, "config.json")
            tmp = cfg_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(config_mod.to_dict(self.cfg), f, indent=1)
            os.replace(tmp, cfg_path)
        if self.mesh is not None:
            dist.barrier()  # the files exist on return, on every rank
        return path

    def load(self, path: str) -> None:
        """Restore a checkpoint written by `save` onto this trainer's
        device, whichever device or mesh wrote it.  On a mesh every rank
        reads it and keeps its block; a checkpoint without one generator
        per block (a one-device trainer's, or another mesh's) reseeds the
        blocks' generators from (seed, block)."""
        payload = ckpt_mod.restore(path, map_location=self.device)
        params, opt_state = payload["params"], payload["opt_state"]
        adc = densify_mod.AdcState(**payload["adc"])
        resume = payload["resume"]
        generator = resume["adc_generator"]
        if self.mesh is not None:
            params = sharding.shard_params(params, self.mesh)
            opt_state = sharding.shard_opt_state(opt_state, self.mesh)
            adc = sharding.shard_tree(adc, adc.count.shape[0], self.mesh)
            states = resume.get("adc_generators", [])
            n_shards = self.mesh.size(GAUSS_AXIS)
            generator = (states[self.mesh.axis_index(GAUSS_AXIS)] if len(states) == n_shards
                         else torch.Generator().manual_seed(self._adc_seed()).get_state())
        with self.lock:
            self.params, self.opt_state, self.adc = params, opt_state, adc
            self.step = int(payload["step"])
            self._adc_generator.set_state(generator.cpu())
            self._rng.bit_generator.state = resume["rng"]
            self._clip_floor = resume["clip_floor"]
            self._clip_warn_at = resume["clip_warn_at"]
            self._screen_prune_armed = resume["screen_prune_armed"]
