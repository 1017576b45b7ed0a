"""Command line: train / eval / render / export.  Counterpart of
casualhdrsplat_tpu/cli.py:

    python -m casualhdrsplat_torch.cli <command> [--preset name]
        [--checkpoint out_dir/name/step_N] [--device cuda|cpu]
        [dotted.key=value ...]

Every command runs on `--device` (default `cuda`); without a CUDA device it
exits with an error rather than carry on on the CPU, which only
`--device cpu` asks for.  render, eval and export load a checkpoint, and
rebuild the training config from the `config.json` the trainer saved
beside it unless a preset is named.

`train` and `eval` on a mesh (`parallel.data=D parallel.gauss=G`, D G > 1)
run one rank per card in a world that torchrun launches:

    torchrun --nproc_per_node=N -m casualhdrsplat_torch.cli train \
        parallel.gauss=N ...

Each rank joins the world (parallel/distributed.initialize) on the card of
its LOCAL_RANK; rank 0 writes the logs and checkpoints, whose format is the
one-device trainer's.  render and export work on the whole store in one
process, whatever mesh trained it.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def _build_cfg(args):
    from casualhdrsplat_torch import config

    cfg = None
    ck = getattr(args, "checkpoint", None)
    if ck and args.preset == "default":
        # The checkpoint's parameter and optimizer trees depend on the
        # training config (CRF kind, capacity, ...): rebuild it from the
        # config.json the Trainer saved beside the checkpoint.
        cfg_path = os.path.join(os.path.dirname(os.path.abspath(ck)), "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = config.from_dict(json.load(f))
    if cfg is None:
        cfg = config.PRESETS[args.preset]()
    config.with_overrides(cfg, args.overrides)
    return cfg


def _device(args) -> torch.device:
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available "
                         "(pass --device cpu to run on the CPU)")
    return dev


def _world_device(cfg, args, one_process: bool) -> torch.device:
    """The device of this process: under a launched world (torchrun) it
    joins the world first and takes its rank's card.  A mesh above one
    device needs that world; `one_process` commands drop the mesh."""
    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.parallel import distributed

    if one_process:
        cfg.parallel = config.ParallelConfig()
        return _device(args)
    if distributed.launched_world():
        _device(args)  # the same refusal without a card
        return distributed.initialize(device=args.device)
    n = cfg.parallel.data * cfg.parallel.gauss
    if n > 1:
        raise SystemExit(
            f"parallel.data={cfg.parallel.data} parallel.gauss={cfg.parallel.gauss} asks "
            f"for {n} ranks: launch them with torchrun --nproc_per_node={n} -m "
            f"casualhdrsplat_torch.cli {args.command} ...")
    return _device(args)


def _make_trainer(cfg, args, require_checkpoint=False, one_process=False):
    from casualhdrsplat_torch.train.trainer import Trainer

    if require_checkpoint and not args.checkpoint:
        # `render --checkpoint ""` (an empty shell variable) would otherwise
        # render a fresh random init without a word
        raise SystemExit("this command renders or scores a trained model: pass "
                         "--checkpoint <out_dir/name/step_N>")
    t = Trainer(cfg, device=_world_device(cfg, args, one_process))
    if args.checkpoint:
        t.load(args.checkpoint)
    return t


def _host(img) -> np.ndarray:
    return img.detach().cpu().numpy()


def cmd_train(args):
    cfg = _build_cfg(args)
    t = _make_trainer(cfg, args)
    if args.resume and not args.checkpoint:
        from casualhdrsplat_torch.parallel.distributed import resume_or_start

        step = resume_or_start(t, os.path.join(cfg.out_dir, cfg.name))
        if step:
            print(f"resumed from step {step}")
    server = None
    if args.viewer and t.mesh is not None:
        raise SystemExit("--viewer renders the whole store in one process: train on one "
                         "device, or view a checkpoint of the mesh run")
    if args.viewer:
        from casualhdrsplat_torch.viewer.server import ViewerServer, make_orbit_render_fn

        server = ViewerServer(make_orbit_render_fn(t), port=args.viewer_port).start()
        print(f"viewer at http://localhost:{server.port}/")
    try:
        last = t.train()
    finally:
        if server is not None:
            server.stop()
    print("final:", last)
    return last


def cmd_eval(args):
    cfg = _build_cfg(args)
    t = _make_trainer(cfg, args, require_checkpoint=True)
    metrics = t.evaluate()
    print(metrics)
    return metrics


@torch.no_grad()
def cmd_render(args):
    """Render novel views, deblurred frames, HDR frames, exposure sweeps,
    blurred frames or depth maps from a checkpoint (on the card each render
    replays a CUDA graph: `Trainer.renders`)."""
    from casualhdrsplat_torch.models import image_formation as imf
    from casualhdrsplat_torch.train import metrics as metrics_mod

    cfg = _build_cfg(args)
    t = _make_trainer(cfg, args, require_checkpoint=True, one_process=True)
    dev = t.device
    os.makedirs(args.out, exist_ok=True)
    frames = (
        [int(f) for f in args.frames.split(",")]
        if args.frames
        else list(range(min(3, t.dataset.num_frames)))
    )
    gif_frames = []

    def _save(path, img):
        metrics_mod.save_image(path, img)
        if args.gif:
            gif_frames.append((np.clip(img, 0.0, 1.0) * 255).astype(np.uint8))

    def _mid_pose(i):
        mid = t.scene.timestamps[i] + 0.5 * imf.exposure_of(t.params, i)
        return imf.poses_at(t.params, t.scene, mid.reshape(1), cfg.model)[0]

    if args.mode == "novel":
        # Continuous-time novel views: the optimized SE(3) spline is a
        # smooth camera path through the capture, so sample it densely
        # between the first and the last frame and render sharp views at
        # one virtual exposure (the learned geometric mean unless given).
        t0 = float(t.scene.timestamps[0])
        last = t.dataset.num_frames - 1
        t1 = float(t.scene.timestamps[last]) + float(imf.exposure_of(t.params, last))
        times = torch.as_tensor(np.linspace(t0, t1, args.path_n), dtype=torch.float32,
                                device=dev)
        dt = (torch.tensor(args.exposure, device=dev) if args.exposure > 0
              else torch.exp(torch.mean(t.params["log_exposures"])))
        viewmats = imf.poses_at(t.params, t.scene, times, cfg.model)
        for j in range(args.path_n):
            img, _, _ = t.renders.render_pose(t.params, t.scene, viewmats[j], cfg.model,
                                              exposure=dt)
            _save(os.path.join(args.out, f"novel_{j:04d}.png"), _host(img))
        frames = []

    for i in frames:
        # render_deblurred: one sharp view at the mid-exposure pose
        if args.mode == "deblur":
            img, _, _ = t.renders.render_pose(t.params, t.scene, _mid_pose(i), cfg.model,
                                              exposure=imf.exposure_of(t.params, i))
            _save(os.path.join(args.out, f"deblur_{i:04d}.png"), _host(img))
        elif args.mode == "depth":
            # expected depth at the mid-exposure pose
            depth, alpha, _ = t.renders.render_pose(t.params, t.scene, _mid_pose(i),
                                                    cfg.model, depth_output=True)
            d = _host(depth)
            np.save(os.path.join(args.out, f"depth_{i:04d}.npy"), d)
            cover = _host(alpha) > 1e-3
            lo = float(d[cover].min()) if cover.any() else 0.0
            hi = float(d[cover].max()) if cover.any() else 1.0
            vis = np.where(cover, (d - lo) / max(hi - lo, 1e-6), 0.0)
            _save(os.path.join(args.out, f"depth_{i:04d}.png"),
                  np.tile(vis[..., None], (1, 1, 3)))
        elif args.mode == "hdr":
            img, _, _ = t.renders.render_pose(t.params, t.scene, _mid_pose(i), cfg.model,
                                              exposure=imf.exposure_of(t.params, i),
                                              hdr_output=True)
            np.save(os.path.join(args.out, f"hdr_{i:04d}.npy"), _host(img))
            metrics_mod.save_hdr(os.path.join(args.out, f"hdr_{i:04d}.hdr"), _host(img))
        elif args.mode == "exposure-sweep":
            viewmat = _mid_pose(i)
            for j, dt in enumerate(np.geomspace(args.sweep_min, args.sweep_max, args.sweep_n)):
                img, _, _ = t.renders.render_pose(t.params, t.scene, viewmat, cfg.model,
                                                  exposure=float(np.float32(dt)))
                _save(os.path.join(args.out, f"sweep_{i:04d}_{j:02d}.png"), _host(img))
        else:  # blurred: reproduce the captured frame
            blurred = t.renders.render_frame_blurred(t.params, t.scene, i, cfg.model)
            _save(os.path.join(args.out, f"blur_{i:04d}.png"), _host(blurred))
    if args.gif and gif_frames:
        # PIL writes the GIF, the natural preview of a video method
        from PIL import Image

        ims = [Image.fromarray(f) for f in gif_frames]
        fps = max(args.gif_fps, 0.1)  # guards --gif-fps 0 and negatives
        ims[0].save(args.gif, save_all=True, append_images=ims[1:],
                    duration=max(1, int(1000 / fps)), loop=0)
        print(f"wrote {len(ims)}-frame gif to {args.gif}")
    print(f"wrote renders to {args.out}")


def cmd_export(args):
    from casualhdrsplat_torch.train import checkpoint as ckpt_mod

    cfg = _build_cfg(args)
    t = _make_trainer(cfg, args, require_checkpoint=True, one_process=True)
    n = ckpt_mod.export_ply(args.out, t.params["gaussians"])
    print(f"wrote {n} Gaussians to {args.out}")
    return n


def main(argv=None):
    """Run one command; returns what the command returns (the final step's
    scalars, the eval metrics, the exported Gaussian count)."""
    p = argparse.ArgumentParser(prog="casualhdrsplat_torch")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--preset", default="default", help="config preset name")
        sp.add_argument("--checkpoint", default=None, help="checkpoint dir to load")
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; cpu on request only)")
        sp.add_argument("overrides", nargs="*", default=[],
                        help="dotted config overrides k=v")

    sp = sub.add_parser("train")
    common(sp)
    sp.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in out_dir")
    sp.add_argument("--viewer", action="store_true",
                    help="serve a live web viewer during training")
    sp.add_argument("--viewer-port", type=int, default=7007)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval")
    common(sp)
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("render")
    common(sp)
    sp.add_argument("--mode", default="deblur",
                    choices=["deblur", "hdr", "exposure-sweep", "blurred", "depth", "novel"])
    sp.add_argument("--path-n", type=int, default=60,
                    help="novel mode: number of samples along the spline")
    sp.add_argument("--exposure", type=float, default=0.0,
                    help="novel mode: virtual exposure (0 = learned mean)")
    sp.add_argument("--out", default="renders")
    sp.add_argument("--frames", default="", help="comma-separated frame ids")
    sp.add_argument("--gif", default="", help="also assemble the rendered "
                    "frames into an animated GIF at this path")
    sp.add_argument("--gif-fps", type=float, default=8.0)
    sp.add_argument("--sweep-min", type=float, default=0.1)
    sp.add_argument("--sweep-max", type=float, default=4.0)
    sp.add_argument("--sweep-n", type=int, default=7)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("export")
    common(sp)
    sp.add_argument("--out", default="gaussians.ply")
    sp.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    finally:
        from casualhdrsplat_torch.parallel import distributed

        # leave the world joined under torchrun (_world_device) before the
        # process ends, as torch.distributed asks
        if distributed.launched_world() and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
