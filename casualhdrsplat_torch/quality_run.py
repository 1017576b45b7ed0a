"""At-spec quality run of the port.  Counterpart of the reference's
`scripts/quality_run.py`:

    python -m casualhdrsplat_torch.quality_run [flags]   # --device cpu off the card

Trains the full joint model (poses, exposures, CRF, HDR Gaussians,
density control) at 800x800 on a synthetic casual video with known ground
truth, then scores:

- the blurred-frame fit (PSNR/SSIM curve);
- deblurred renders against the sharp ground truth, and the deblurring
  gain over the blurry inputs;
- exposure-ratio recovery (the global scale is a gauge);
- CRF recovery: RMSE of the learned curve against the ground truth's gamma
  curve after the best log-exposure shift (the chain's scale gauge);
- pose recovery: the trajectory at the sampled times against the ground
  truth's (the initial knots are perturbed, as COLMAP on blurry frames
  would leave them).

The report (`--out`) is rewritten after every eval and on every exit path;
each eval also appends its curve point to `<out>.progress` and writes a
checkpoint under `<render-dir>/ckpt`, from which the next launch resumes
(`--fresh` starts over).  The best eval's checkpoint is never pruned.
`outputs/quality.stop` (relative to the working directory) or
`--max-minutes` ends a run early, cleanly.  Defaults write under
`chiprun_out/quality/`.

Differences from the reference: the initial knot perturbation is drawn
from a CPU `torch.Generator` seeded 3, not from `jax.random.PRNGKey(3)`
(`initial_knot_deltas`); the report adds `device` and `rasterize`, the
rasterizer config that actually ran; `--device`, `--fixture-cache`,
`--eval-every-steps` and `--align-steps` are the port's own flags (their
defaults are the reference's behaviour).  The TPU's chip lock and compile
cache have no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time

import numpy as np
import torch

from casualhdrsplat_torch import config
from casualhdrsplat_torch.data import dataset as dataset_mod
from casualhdrsplat_torch.data import synthetic
from casualhdrsplat_torch.models import crf as crf_mod
from casualhdrsplat_torch.models import image_formation as imf
from casualhdrsplat_torch.models import losses
from casualhdrsplat_torch.train import checkpoint as ckpt_mod
from casualhdrsplat_torch.train import metrics as metrics_mod
from casualhdrsplat_torch.train.trainer import Trainer

# The rasterizer the ground truth is rendered with: a one-time cost, so the
# stream is over-provisioned (the structured fixture's surfels at 800x800
# need more than the training defaults; make_casual_video raises if
# anything is dropped).
GT_RASTER = dict(shared_binning=False, stream_factor=24, max_tiles_per_gaussian=64,
                 tile_capacity=4096, tile_h=16, tile_w=16, chunk=256)
STOP_FILE = os.path.join("outputs", "quality.stop")


def crf_recovery_rmse(params, crf_cfg, gamma: float):
    """RMSE between the learned response curve and the ground truth's gamma
    curve, minimised over a log-exposure shift (the chain's scale gauge)."""
    e = np.exp(np.linspace(np.log(1e-3), np.log(3.0), 256))
    deltas = np.linspace(-2.0, 2.0, 161)
    dev = next(iter(params.values())).device if params else "cpu"
    exposed = np.tile((e[None, :] * np.exp(deltas)[:, None])[..., None], (1, 1, 3))
    with torch.no_grad():
        learned = crf_mod.apply(
            params, torch.as_tensor(exposed, dtype=torch.float32, device=dev), crf_cfg
        ).cpu().numpy().astype(np.float64)  # [deltas, 256, 3]
    gt = np.clip(e, 0.0, 1.0) ** (1.0 / gamma)
    rmse = np.sqrt(np.mean((learned - gt[None, :, None]) ** 2, axis=(1, 2)))
    best = int(np.argmin(rmse))  # the first of equal minima, as a strict < scan
    return {"rmse": float(rmse[best]), "log_shift": float(deltas[best])}


@torch.no_grad()
def hdr_recovery_metrics(t, video, eval_idx, deg, crf_cfg, gamma=2.2):
    """Gauge-aligned HDR radiance recovery: the chain H x dt x CRF has a
    global scale gauge, so the rendered linear-HDR deblurs are aligned to
    the fixture's ground-truth radiance by one least-squares scalar before
    scoring.

    - eval_hdr_psnr: PSNR of the aligned HDR renders against the ground
      truth's sharp HDR, peak = its maximum;
    - exposure_sweep_psnr: HDR exposure-editing fidelity, CRF_pred(s x
      H_pred x dt) against the ground-truth chain clip(H_gt x dt)^(1/gamma)
      over a 16x sweep of virtual exposures, which couples the recovered
      radiance, CRF and exposure gauges as a user's slider would."""
    preds, gts = [], []
    for i in eval_idx[:3]:
        hdr, _ = t.renders.deblurred_scores(t.params, t.scene, int(i), t.cfg.model,
                                            hdr_output=True, sh_degree=deg)
        preds.append(hdr.cpu().numpy())
        gts.append(np.asarray(video.sharp_hdr[int(i)].cpu()))
    p, g = np.stack(preds), np.stack(gts)
    if p.shape != g.shape:
        # coarse curriculum rung: deblurs render at the rung's resolution;
        # score against the box-downscaled ground truth (area average, the
        # filter Dataset.downscaled applies to the LDR frames)
        k = g.shape[1] // p.shape[1]
        b, h, w, _ = p.shape
        g = g.reshape(b, h, k, w, k, 3).mean(axis=(2, 4))
    s = float((p * g).sum() / max((p * p).sum(), 1e-12))
    peak = float(g.max())
    mse = float(((s * p - g) ** 2).mean())
    hdr_psnr = 20 * np.log10(max(peak, 1e-12)) - 10 * np.log10(max(mse, 1e-12))

    sweep = {}
    dev = t.scene.timestamps.device
    for dt_v in (0.25, 1.0, 4.0):
        ldr_pred = crf_mod.apply(
            t.params["crf"], torch.as_tensor(s * p[0] * dt_v, dtype=torch.float32,
                                             device=dev), crf_cfg
        ).cpu().numpy()
        ldr_gt = np.clip(g[0] * dt_v, 0.0, 1.0) ** (1.0 / gamma)
        m = float(((ldr_pred - ldr_gt) ** 2).mean())
        sweep[str(dt_v)] = round(-10 * np.log10(max(m, 1e-12)), 3)
    return {
        "eval_hdr_psnr": round(hdr_psnr, 3),
        "scale_gauge": round(s, 5),
        "exposure_sweep_psnr": sweep,
    }


def build_fixture(knobs: dict, device="cuda", cache_dir=os.path.join("outputs",
                                                                     "fixture_cache")):
    """The deterministic ground-truth fixture and its Dataset from the knob
    dict kept beside the checkpoint (ckpt/fixture.json), so that a
    checkpoint is always scored against the fixture it trained on.  The
    fixture is cached under the reference's key: either package reads the
    other's."""
    kpf = knobs["knots_per_frame"]
    video = synthetic.cached_casual_video(
        cache_dir, 42, device=device,
        n_gaussians=knobs["gt_gaussians"],
        n_frames=knobs["frames"],
        n_virtual=16,
        size=knobs["size"],
        angle_span=0.8,
        exposure_range=tuple(knobs["exposure_range"]),
        crf_gamma=2.2,
        hdr_max=3.0,
        extent=2.2,
        scale_range=(0.004, 0.016),
        renderer="fast",
        raster_cfg=config.RasterizeConfig(**GT_RASTER),
        cloud_kind="structured" if knobs["fixture"] == "structured" else "random",
        shake_rot=knobs["shake"][0],
        shake_trans=knobs["shake"][1],
        knots_per_frame=kpf,
    )
    n = video.images.shape[0]
    cam = video.camera
    knots = video.knots.cpu().numpy()
    ds = dataset_mod.Dataset(
        images=video.images.cpu().numpy(),
        timestamps=video.timestamps.cpu().numpy(),
        # frame-time poses off the (dense, shaken) ground-truth knot grid:
        # the initialisation COLMAP on blurry frames would give
        viewmats=np.asarray([knots[2 + i * kpf] for i in range(n)], np.float32),
        fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy),
        width=cam.width, height=cam.height,
        points_xyz=video.cloud.means3d.cpu().numpy(),
        points_rgb=np.clip(video.cloud.colors.cpu().numpy(), 0, 1),
        sharp_images=video.sharp_ldr.cpu().numpy(),
    )
    return video, ds


def write_json(path: str, report: dict) -> None:
    """Write `report` to `path` through a temporary file, so that a reader
    never sees half a report."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=1)
    os.replace(tmp, path)


def initial_knot_deltas(shape, device):
    """The perturbed initial knots, as COLMAP on blurry frames would leave
    them: 0.002 x a standard normal draw from a CPU generator seeded 3 (the
    reference draws from jax.random.PRNGKey(3); the numbers differ)."""
    return (0.002 * torch.randn(shape, generator=torch.Generator().manual_seed(3))).to(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--gt-gaussians", type=int, default=30_000)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--steps", type=int, default=4_000)
    ap.add_argument("--capacity", type=int, default=1 << 17)
    ap.add_argument("--virtual-views", type=int, default=8)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "quality",
                                                  "QUALITY_torch.json"))
    ap.add_argument("--render-dir", default=os.path.join("chiprun_out", "quality"))
    ap.add_argument("--fixture-cache", default=os.path.join("outputs", "fixture_cache"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    # "structured" (a piecewise-smooth textured room, which a fit can win)
    # or the legacy random "confetti"
    ap.add_argument("--fixture", default="structured", choices=["structured", "confetti"])
    # Handheld shake: per-dense-knot SE(3) jitter (rad / world units), the
    # main source of casual-video blur (rotation moves the whole frame; the
    # look-at orbit alone never blurs central content).
    ap.add_argument("--shake-rot", type=float, default=0.06)
    ap.add_argument("--shake-trans", type=float, default=0.03)
    # sub-frame spline control points (ground truth and model share the grid)
    ap.add_argument("--knots-per-frame", type=int, default=3)
    ap.add_argument("--pose-warmup", type=int, default=100)
    ap.add_argument("--pose-trans-lr-scale", type=float, default=0.1)
    ap.add_argument("--exposure-lr", type=float, default=5e-3)
    # exposure gradients are per-frame sparse like the knots'; b1 = 0 stops
    # a random walk of stale momentum
    ap.add_argument("--exposure-b1", type=float, default=0.0)
    # diagnostic: start the (still learnable) log exposures at the truth
    ap.add_argument("--gt-exposure-init", action="store_true")
    # per-window pose restart at launch: refine the K worst train frames'
    # windows against their blurry inputs first (0 = off)
    ap.add_argument("--realign-windows", type=int, default=0)
    ap.add_argument("--realign-steps", type=int, default=48)
    ap.add_argument("--exposure-init-frac", type=float, default=0.75)
    ap.add_argument("--crf-lr", type=float, default=1e-3)
    # loss-blur coarse-to-fine (off by default; the resolution curriculum
    # below replaced it)
    ap.add_argument("--c2f-steps", type=int, default=0)
    ap.add_argument("--c2f-sigma", type=float, default=10.0)
    # Resolution curriculum: the first --coarse-steps steps on a
    # --coarse-downscale'd dataset, then the same parameters, optimizer and
    # density-control state at full resolution.
    ap.add_argument("--coarse-steps", type=int, default=0)
    ap.add_argument("--coarse-downscale", type=int, default=2)
    # footprint budget of the full-resolution rung (max_tiles_per_gaussian)
    ap.add_argument("--mtpg-full", type=int, default=256)
    # screen prune radius (fraction of the width)
    ap.add_argument("--prune-screen-radius", type=float, default=0.20)
    ap.add_argument("--pose-anchor-w", type=float, default=0.0)
    # momentum-free pose Adam (sparse per-frame knot gradients)
    ap.add_argument("--pose-b1", type=float, default=0.0)
    ap.add_argument("--pose-lr-final", type=float, default=1e-4)
    # restart the pose decay clock at the curriculum's promotion
    ap.add_argument("--pose-rewarm", action="store_true")
    ap.add_argument("--densify-start", type=int, default=500)
    ap.add_argument("--antialias", action="store_true")
    # hold out every k-th frame and score novel views on them
    ap.add_argument("--holdout-every", type=int, default=6)
    ap.add_argument("--exposure-lo", type=float, default=0.5)
    ap.add_argument("--exposure-hi", type=float, default=1.0)
    # per-view binning (exact) unless asked for shared binning
    ap.add_argument("--shared-binning", action="store_true")
    ap.add_argument("--stream-factor", type=int, default=12)
    ap.add_argument("--max-minutes", type=float, default=0.0,
                    help="cooperative wall-clock stop (0 = unbounded), checked between "
                         "steps; the report and checkpoint are still written")
    # evals fire every --eval-every-steps steps, at the last step, and
    # whenever --eval-every-s seconds passed since the last one
    ap.add_argument("--eval-every-s", type=float, default=300.0)
    ap.add_argument("--eval-every-steps", type=int, default=1000)
    # Adam steps of the final test-time pose alignment of every eval frame
    ap.add_argument("--align-steps", type=int, default=64)
    ap.add_argument("--run-label", default="")
    ap.add_argument("--fresh", action="store_true",
                    help="ignore an existing checkpoint and progress and start from step 0")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("quality_run: no CUDA device; pass --device cpu for a CPU run",
              file=sys.stderr)
        return 2
    device = torch.device(args.device)
    t_start = time.time()
    ckpt_root = os.path.abspath(os.path.join(args.render_dir, "ckpt"))
    progress_path = args.out + ".progress"
    if args.fresh and os.path.exists(progress_path):
        os.remove(progress_path)
    # Provenance guard: a checkpoint under ckpt_root resumes only into the
    # same fixture and raster regime.  These knobs are kept beside it, and
    # a resume that asks for others refuses.
    fixture_knobs = {
        "size": args.size, "gt_gaussians": args.gt_gaussians,
        "frames": args.frames, "capacity": args.capacity,
        "virtual_views": args.virtual_views,
        "exposure_range": [args.exposure_lo, args.exposure_hi],
        "shared_binning": bool(args.shared_binning),
        "stream_factor": args.stream_factor,
        "fixture": args.fixture,
        "shake": [args.shake_rot, args.shake_trans],
        "knots_per_frame": args.knots_per_frame,
        "antialias": bool(args.antialias),
        "pose_warmup": args.pose_warmup,
        "pose_trans_lr_scale": args.pose_trans_lr_scale,
        "exposure_lr": args.exposure_lr,
        "exposure_init_frac": args.exposure_init_frac,
        "crf_lr": args.crf_lr,
        "c2f": [args.c2f_steps, args.c2f_sigma],
        "holdout_every": args.holdout_every,
        "coarse": [args.coarse_steps, args.coarse_downscale],
        "pose_anchor_w": args.pose_anchor_w,
        "densify_start": args.densify_start,
        "pose_b1": args.pose_b1,
        "gt_exposure_init": bool(args.gt_exposure_init),
    }
    print("generating GT fixture...", flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    video, ds = build_fixture(fixture_knobs, device, args.fixture_cache)
    kpf = args.knots_per_frame
    n = video.images.shape[0]
    gt_gen_s = time.time() - t_start
    peak = (f", peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if device.type == "cuda" else "")
    print(f"fixture: {n} frames @ {args.size}^2, {gt_gen_s:.0f}s{peak}", flush=True)

    cfg = config.TrainConfig(name="quality-torch")
    cfg.model.max_gaussians = args.capacity
    cfg.model.sh_degree = 3
    cfg.model.num_virtual_views = args.virtual_views
    cfg.model.knots_per_frame = kpf
    cfg.model.crf.kind = "mlp"
    cfg.optim.pose_warmup_steps = args.pose_warmup
    cfg.optim.pose_trans_lr_scale = args.pose_trans_lr_scale
    cfg.optim.exposure_lr = args.exposure_lr
    cfg.optim.exposure_b1 = args.exposure_b1
    cfg.optim.crf_lr = args.crf_lr
    cfg.model.exposure_init_frac = args.exposure_init_frac
    cfg.loss.coarse_to_fine_steps = args.c2f_steps
    cfg.loss.coarse_sigma0 = args.c2f_sigma
    cfg.loss.pose_anchor_weight = args.pose_anchor_w
    cfg.optim.pose_b1 = args.pose_b1
    cfg.optim.pose_lr_final = args.pose_lr_final
    if args.pose_rewarm and args.coarse_steps > 0:
        cfg.optim.pose_lr_rewarm_step = args.coarse_steps
    elif args.pose_rewarm:
        # without a curriculum there is no promotion step to re-warm at
        raise SystemExit("--pose-rewarm requires --coarse-steps > 0 "
                         "(the rewarm fires at curriculum promotion)")
    # chunk 256; max_tiles_per_gaussian 64 on the coarse rung (the budget
    # the ground truth renders with), --mtpg-full at full resolution
    cfg.model.rasterize = config.RasterizeConfig(
        tile_h=16, tile_w=16, tile_capacity=1024, max_tiles_per_gaussian=64,
        chunk=256, backend="auto", stream_factor=args.stream_factor,
        shared_binning=args.shared_binning, antialias=args.antialias,
    )
    cfg.densify.enabled = True
    cfg.densify.start_iter = args.densify_start
    cfg.densify.interval = 100
    cfg.densify.stop_iter = int(args.steps * 0.6)
    cfg.densify.grad_threshold = 4e-4
    # no opacity resets inside a run: each costs about 1000 steps of recovery
    cfg.densify.opacity_reset_interval = 10 * args.steps
    # ...but resets are what normally arm the screen-radius prune: arm it
    # explicitly, so that oversized splats cannot blow up the binning budget
    cfg.densify.screen_prune_from = 600
    cfg.densify.prune_screen_radius = args.prune_screen_radius
    cfg.optim.max_steps = args.steps
    cfg.data.eval_every = args.holdout_every
    cfg.log_every = 100
    cfg.eval_every = 0  # evals are driven from here
    cfg.checkpoint_every = 0
    cfg.out_dir = args.render_dir

    def make_trainer(active_ds):
        # the footprint budget scales with focal^2: splats sized for the
        # coarse rung can exceed 64 tiles at full resolution
        rung_full = active_ds.width >= args.size
        cfg.model.rasterize = dataclasses.replace(
            cfg.model.rasterize,
            max_tiles_per_gaussian=args.mtpg_full if rung_full else 64,
        )
        tt = Trainer(cfg, active_ds, device=device)
        # noisy initial poses, so that the run shows joint pose estimation
        # (set before any resume: the same perturbed init on every launch)
        tt.params["knot_deltas"] = initial_knot_deltas(tt.params["knot_deltas"].shape, device)
        if args.gt_exposure_init:
            tt.params["log_exposures"] = torch.log(video.exposures.float()).to(device)
        return tt

    # Which rung does this launch start on?  A resume peeks at the
    # checkpointed step first: the parameters and optimizer state do not
    # depend on the resolution, only the images and intrinsics do.
    ds_coarse = ds.downscaled(args.coarse_downscale) if args.coarse_steps > 0 else None
    peek = 0
    if not args.fresh:
        latest = ckpt_mod.latest_step_dir(ckpt_root)
        if latest:
            peek = int(os.path.basename(latest).split("_")[1])
    on_coarse = ds_coarse is not None and peek < args.coarse_steps
    t = make_trainer(ds_coarse if on_coarse else ds)

    def promote_to_full():
        """Coarse -> full resolution: the same parameters, optimizer and
        density-control state on the full-resolution dataset."""
        nonlocal t, on_coarse
        print(f"coarse phase done at step {t.step} — promoting to {args.size}^2", flush=True)
        tnew = make_trainer(ds)
        tnew.params, tnew.opt_state = t.params, t.opt_state
        tnew.adc, tnew.step = t.adc, t.step
        t, on_coarse = tnew, False

    traj_times = metrics_mod.exposure_window_times(
        video.timestamps.cpu().numpy(), video.exposures.cpu().numpy())
    gt_knots = video.knots.cpu().numpy()

    def traj_errors():
        """Pose error at the sampled trajectory times (the exposure
        windows): knots outside them are a null space of the objective."""
        with torch.no_grad():
            est = imf.effective_knots(t.params, t.scene).cpu().numpy()
        return metrics_mod.trajectory_recovery_errors(
            gt_knots, video.knot_t0, video.knot_dt, est,
            float(t.scene.knot_t0), float(t.scene.knot_dt), traj_times,
        )

    rot0, trans0 = traj_errors()
    fixture_path = os.path.join(ckpt_root, "fixture.json")
    gt_log_exposures = np.log(video.exposures.cpu().numpy())

    def recovery_now():
        """Gauge-aligned pose and exposure recovery, added to every curve
        point.  The rotation error per frame names the windows that carry
        the maximum; the error arrays can be shorter than n x 5 (a window
        end past the spline's support is dropped), so group by index."""
        rot, trans = traj_errors()
        got = t.params["log_exposures"].detach().cpu().numpy()
        err = np.abs((got - got.mean()) - (gt_log_exposures - gt_log_exposures.mean()))
        rot_np = np.asarray(rot)
        frame_of = np.repeat(np.arange(n), len(traj_times) // n)[: len(rot_np)]
        per_frame = np.asarray([
            rot_np[frame_of == f].mean() if np.any(frame_of == f) else 0.0
            for f in range(n)
        ])
        return {
            "rot_deg_mean": float(rot.mean()), "rot_deg_max": float(rot.max()),
            "trans_mean": float(trans.mean()), "trans_max": float(trans.max()),
            "exp_err_mean": float(err.mean()), "exp_err_max": float(err.max()),
            "rot_per_frame": [round(float(x), 3) for x in per_frame],
        }

    # Fit and deblur metrics on train frames only: a held-out frame's own
    # exposure never trains (held-out frames get the novel-view metric).
    tr = list(t.dataset.train_indices)
    eval_idx = [tr[i] for i in range(0, len(tr), max(1, len(tr) // 6))]
    curve = []
    if not args.fresh:
        # Resume: the fixture is deterministic, so restoring the checkpoint
        # continues the same run; the curve so far is in the .progress file.
        from casualhdrsplat_torch.parallel.distributed import resume_or_start

        if os.path.exists(fixture_path):
            with open(fixture_path) as f:
                saved = json.load(f)
            # compare the keys both know; report any difference in the sets
            shared = set(saved) & set(fixture_knobs)
            diff = {k: (saved[k], fixture_knobs[k]) for k in shared
                    if saved[k] != fixture_knobs[k]}
            if diff:
                raise SystemExit(
                    f"checkpoint at {ckpt_root} was trained with different "
                    f"fixture knobs {diff} ((saved, requested)) — pass "
                    "--fresh to restart, or match the original flags"
                )
            dropped = set(saved) - set(fixture_knobs)
            added = set(fixture_knobs) - set(saved)
            if dropped or added:
                print(f"fixture-knob schema drift on resume: dropped={sorted(dropped)} "
                      f"added={sorted(added)} (values compared on shared keys only)",
                      flush=True)
        resumed = resume_or_start(t, ckpt_root)
        if resumed:
            if os.path.exists(progress_path):
                with open(progress_path) as f:
                    curve = [json.loads(ln) for ln in f if ln.strip()]
                curve = [e for e in curve if e["step"] <= resumed]
            print(f"resumed from step {resumed} ({len(curve)} eval points restored)",
                  flush=True)
        elif os.path.exists(progress_path):
            os.remove(progress_path)  # stale: no checkpoint to match it

    if args.realign_windows > 0:
        # Per-window pose restart at launch: the K worst train frames by
        # blurred-fit L1 (no ground truth used), each window refined
        # against its blurry input with the scene frozen.
        from casualhdrsplat_torch.train.pose_align import make_window_realigner

        deg = t.active_sh_degree()
        with torch.no_grad():
            scored = sorted(
                ((float(torch.mean(torch.abs(
                    imf.render_frame(t.params, t.scene, int(f), cfg.model,
                                     sh_degree=deg).blurred_ldr - t.images[int(f)]))),
                  int(f)) for f in t.dataset.train_indices),
                reverse=True,
            )
        worst = scored[: args.realign_windows]
        print(json.dumps({"realign_candidates": [(f, round(v, 5)) for v, f in worst]}),
              flush=True)
        realign = make_window_realigner(cfg.model, steps=args.realign_steps, lr=2e-3,
                                        sh_degree=deg)
        for _, f in worst:
            kd, d, curve_r = realign(t.params, t.scene, f, t.images[f])
            t.params["knot_deltas"] = kd
            dn = d.cpu().numpy()
            print(json.dumps({
                "realigned_frame": f,
                "rot_deg": round(float(np.degrees(np.linalg.norm(dn[:3]))), 4),
                "trans": round(float(np.linalg.norm(dn[3:])), 5),
                "l1_before": round(float(curve_r[0]), 5),
                "l1_after": round(float(curve_r[-1]), 5),
            }), flush=True)
        print(json.dumps({"post_realign": recovery_now()}), flush=True)

    renders_at = -1
    saved_at = t.step
    saved_t = time.time()
    t_train = time.time()
    best_path = os.path.join(ckpt_root, "BEST.json")
    best = {"step": -1, "eval_sharp_psnr": -1.0}
    if os.path.exists(best_path):
        with open(best_path) as f:
            best = json.load(f)

    def save_ckpt():
        nonlocal saved_at, saved_t
        t.save(ckpt_root)
        with open(fixture_path, "w") as f:
            json.dump(fixture_knobs, f, indent=1)
        # keep a small resume window, but never the best eval's checkpoint
        ckpt_mod.prune_step_dirs(ckpt_root, keep=3, protect=best["step"])
        saved_at = t.step
        saved_t = time.time()

    m_round = re.search(r"r(\d+)", os.path.basename(args.out))
    round_no = int(m_round.group(1)) if m_round else 0
    device_name = (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu")

    def write_report():
        """The full report from the curve so far: after every eval and on
        every exit path, even with an empty curve."""
        got = t.params["log_exposures"].detach().cpu().numpy()
        got_c = got - got.mean()
        gt_c = gt_log_exposures - gt_log_exposures.mean()
        exposure_rec = {
            "max_abs_log_ratio_err": float(np.abs(got_c - gt_c).max()),
            "mean_abs_log_ratio_err": float(np.abs(got_c - gt_c).mean()),
        }
        crf_rec = crf_recovery_rmse(t.params["crf"], cfg.model.crf, gamma=2.2)
        hdr_rec = hdr_recovery_metrics(t, video, eval_idx, t.active_sh_degree(),
                                       cfg.model.crf)
        rot1, trans1 = traj_errors()
        pose_rec = {
            "init_rot_deg_mean": float(rot0.mean()),
            "final_rot_deg_mean": float(rot1.mean()),
            "init_trans_mean": float(trans0.mean()),
            "final_trans_mean": float(trans1.mean()),
        }
        final = curve[-1] if curve else None
        report = {
            "round": round_no,
            "run_label": args.run_label,
            "device": device_name,
            "fixture": dict(fixture_knobs),
            # the rasterizer that ran (the trainer's guards may rewrite it)
            "rasterize": dataclasses.asdict(t.cfg.model.rasterize),
            "scale": {
                "image": [args.size, args.size],
                "frames": n,
                "gt_gaussians": args.gt_gaussians,
                "capacity": args.capacity,
                "final_alive": (final["alive"] if final
                                else int(t.params["gaussians"]["alive"].sum())),
                "steps": args.steps,
                "steps_done": int(t.step),
                "virtual_views": args.virtual_views,
            },
            "wall_s": {"gt_gen": round(gt_gen_s, 1),
                       "train": round(time.time() - t_train, 1)},
            "exposure_recovery": exposure_rec,
            "crf_recovery": crf_rec,
            "hdr_recovery": hdr_rec,
            "pose_recovery": pose_rec,
            "psnr_curve": [
                {k: (round(v, 4) if isinstance(v, float) else v) for k, v in e.items()}
                for e in curve
            ],
        }
        if final is not None:
            report["final_eval"] = {k: v for k, v in final.items() if k.startswith("eval")}
            report["deblurring_gain_db"] = round(
                final["eval_sharp_psnr"] - final["eval_sharp_psnr_input"], 3)
        write_json(args.out, report)

    def dump_renders():
        """Deblur / input / ground-truth triplets and an exposure sweep."""
        os.makedirs(args.render_dir, exist_ok=True)
        deg = t.active_sh_degree()
        with torch.no_grad():
            for i in eval_idx[:3]:
                deb, _ = t.renders.deblurred_scores(t.params, t.scene, int(i), cfg.model,
                                                    sh_degree=deg)
                metrics_mod.save_image(
                    os.path.join(args.render_dir, f"deblur_{i:03d}.png"), deb.cpu())
                metrics_mod.save_image(
                    os.path.join(args.render_dir, f"input_{i:03d}.png"), ds.images[int(i)])
                metrics_mod.save_image(
                    os.path.join(args.render_dir, f"gt_sharp_{i:03d}.png"),
                    ds.sharp_images[int(i)])
            # exposure-editing sweep
            mid = t.scene.timestamps[2] + 0.5 * imf.exposure_of(t.params, 2)
            vm = imf.poses_at(t.params, t.scene, mid.reshape(1), cfg.model)[0]
            for j, dt_v in enumerate([0.25, 1.0, 4.0]):
                ldr, _, _ = t.renders.render_pose(t.params, t.scene, vm, cfg.model,
                                                  exposure=torch.tensor(dt_v, device=device))
                metrics_mod.save_image(os.path.join(args.render_dir, f"sweep_{j}.png"),
                                       ldr.cpu())
        print("renders under", args.render_dir, flush=True)

    last_eval_t = time.time()
    last_out = None

    def do_eval(out):
        """Score the current state, add it to the curve, write the report
        and a checkpoint: what a launch leaves behind."""
        nonlocal renders_at, last_eval_t
        m = t.evaluate(indices=eval_idx)
        if args.holdout_every > 0:
            m.update({k: v for k, v in t.evaluate().items() if k.startswith("eval_novel")})
        alive = int(t.params["gaussians"]["alive"].sum())
        entry = {"step": t.step, "res": t.scene.width,
                 "loss": out["loss"] if out else None, "alive": alive,
                 "dropped": out["dropped"] if out else 0.0,
                 "clipped": out["clipped"] if out else 0.0,
                 **m, **recovery_now()}
        curve.append(entry)
        print(json.dumps(entry), flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(progress_path)), exist_ok=True)
        with open(progress_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        write_report()
        if m.get("eval_sharp_psnr", -1.0) > best["eval_sharp_psnr"]:
            best.update(step=int(t.step), eval_sharp_psnr=float(m["eval_sharp_psnr"]))
            os.makedirs(ckpt_root, exist_ok=True)
            with open(best_path, "w") as f:
                json.dump(best, f)
        save_ckpt()  # the next launch resumes here
        last_eval_t = time.time()
        if t.step % 2000 == 0:
            dump_renders()
            renders_at = t.step

    beat_t, beat_step = time.time(), t.step
    while t.step < cfg.optim.max_steps:
        out = t.run_step()
        last_out = out
        if on_coarse and t.step >= args.coarse_steps:
            promote_to_full()
        if t.step % 200 == 0 and t.step % 1000 != 0:
            # heartbeat between evals: overflow health and the step rate
            now = time.time()
            beat = {"step": t.step, "loss": round(out["loss"], 5),
                    "dropped": out["dropped"], "clipped": out["clipped"],
                    "s_per_step": round((now - beat_t) / max(t.step - beat_step, 1), 4)}
            if device.type == "cuda":
                beat["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 2)
            print(json.dumps(beat), flush=True)
            beat_t, beat_step = now, t.step
        if time.time() - saved_t > 300.0:
            save_ckpt()  # time-based: an abrupt end loses at most 5 minutes
        if (t.step % args.eval_every_steps == 0 or t.step == cfg.optim.max_steps
                or time.time() - last_eval_t > args.eval_every_s):
            do_eval(out)
        if os.path.exists(STOP_FILE):
            print("stop file seen — finishing early", flush=True)
            break
        if args.max_minutes and (time.time() - t_start) > args.max_minutes * 60:
            print(f"max-minutes ({args.max_minutes}) reached — finishing early", flush=True)
            break

    # Exit paths (stop file, max-minutes, or a resume already at max_steps):
    # score this launch's end and leave the report and checkpoint current.
    if not curve or curve[-1]["step"] != t.step:
        do_eval(last_out)
    elif t.step != saved_at:
        save_ckpt()
    print("wrote", args.out, flush=True)
    if t.step >= cfg.optim.max_steps and renders_at != t.step:
        dump_renders()
    if t.step >= cfg.optim.max_steps:
        # the headline metric, at completion
        gain = merge_aligned(args.out, aligned_block(
            t, eval_idx, args.align_steps, holdout=list(t.dataset.eval_indices)))
        print(f"aligned deblurring gain {gain:+.2f} dB", flush=True)
    return 0


def aligned_block(t, eval_idx, steps: int, lr: float = 2e-3, holdout=(), save_dir=None):
    """Test-time pose-aligned scores (per-frame 6-DoF alignment of the
    mid-exposure render against the sharp ground truth, with scene, CRF and
    exposure frozen: the BARF / BAD-NeRF protocol) of the train frames
    `eval_idx`, and aligned novel views of the held-out frames `holdout` at
    the interpolated exposure.  With `save_dir`, the aligned deblurs are
    written there as deblur_aligned_<frame>.png."""
    from casualhdrsplat_torch.train.pose_align import make_aligner

    model = t.cfg.model
    deg = t.active_sh_degree()
    dev = t.scene.timestamps.device
    align = make_aligner(model, steps=steps, lr=lr, sh_degree=deg)

    def scored(i, dt):
        """(raw render, aligned render, align delta, ground truth) of frame
        i at its mid-exposure pose, exposure dt."""
        gt = torch.as_tensor(t.dataset.sharp_images[int(i)], device=dev)
        with torch.no_grad():
            t_mid = t.scene.timestamps[int(i)] + 0.5 * dt
            vm = imf.poses_at(t.params, t.scene, t_mid.reshape(1), model)[0]
            raw, _, _ = t.renders.render_pose(t.params, t.scene, vm, model, exposure=dt,
                                              sh_degree=deg)
        aligned, delta, _ = align(t.params, t.scene, vm, dt, gt)
        return raw, aligned, delta, gt

    raw_p, al_p, al_s, in_p, deltas = [], [], [], [], []
    for i in eval_idx:
        with torch.no_grad():
            dt = imf.exposure_of(t.params, int(i))
        raw, aligned, delta, gt = scored(i, dt)
        raw_p.append(float(losses.psnr(raw, gt)))
        al_p.append(float(losses.psnr(aligned, gt)))
        al_s.append(float(losses.ssim(aligned, gt)))
        in_p.append(float(losses.psnr(torch.as_tensor(t.dataset.images[int(i)], device=dev),
                                      gt)))
        d = delta.cpu().numpy()
        deltas.append({
            "frame": int(i),
            "rot_deg": round(float(np.degrees(np.linalg.norm(d[:3]))), 4),
            "trans": round(float(np.linalg.norm(d[3:])), 5),
        })
        if save_dir is not None:
            metrics_mod.save_image(os.path.join(save_dir, f"deblur_aligned_{int(i):03d}.png"),
                                   aligned.cpu())
    block = {
        "protocol": "per-frame 6-DoF test-time pose alignment, scene/CRF/exposure frozen "
                    f"(BARF / BAD-NeRF protocol); {steps} Adam steps @ lr {lr:g}",
        "at_step": int(t.step),
        "eval_sharp_psnr_raw": round(float(np.mean(raw_p)), 4),
        "eval_sharp_psnr_aligned": round(float(np.mean(al_p)), 4),
        "eval_sharp_ssim_aligned": round(float(np.mean(al_s)), 4),
        "eval_sharp_psnr_input": round(float(np.mean(in_p)), 4),
        "align_deltas": deltas,
    }
    if len(holdout):
        nv_raw, nv_al, nv_ssim = [], [], []
        for i in holdout:
            log_e = imf.interpolated_log_exposure(
                t.params, t.dataset.timestamps, t.dataset.train_indices, int(i))
            raw, aligned, _, gt = scored(i, torch.tensor(float(np.exp(log_e)), device=dev))
            nv_raw.append(float(losses.psnr(raw, gt)))
            nv_al.append(float(losses.psnr(aligned, gt)))
            nv_ssim.append(float(losses.ssim(aligned, gt)))
        block["eval_novel_psnr_raw"] = round(float(np.mean(nv_raw)), 4)
        block["eval_novel_psnr_aligned"] = round(float(np.mean(nv_al)), 4)
        block["eval_novel_ssim_aligned"] = round(float(np.mean(nv_ssim)), 4)
    return block


def merge_aligned(path: str, block: dict) -> float:
    """Add the aligned block and its deblurring gain to the report at
    `path` (created if absent); returns the gain in dB."""
    report = {}
    if os.path.exists(path):
        with open(path) as f:
            report = json.load(f)
    report["final_eval_aligned"] = block
    report["deblurring_gain_db_aligned"] = round(
        block["eval_sharp_psnr_aligned"] - block["eval_sharp_psnr_input"], 3)
    write_json(path, report)
    return report["deblurring_gain_db_aligned"]


if __name__ == "__main__":
    sys.exit(main())
