"""The port's entry points.  Counterparts of the reference's
`__graft_entry__.entry()` and `dryrun_multichip`:

    fn, args = entry()        # device="cuda"; pass device="cpu" for a CPU run
    blurred = fn(*args)       # render_frame(...).blurred_ldr, [32, 32, 3]

    dryrun_multichip(4)       # a world of 4 ranks, one card each (nccl)
    dryrun_multichip(2, backend="gloo")   # two ranks on one card
    dryrun_multichip(4, device="cpu")     # CPU processes (gloo)

`fn` is the forward of the full image-formation chain (spline virtual
poses, batched HDR rasterization through kernel B1, CRF, blur mean) on a
tiny synthetic scene.  `dryrun_multichip` trains on a (data, gauss) mesh
through the production Trainer: the packed rasterizer over the mesh
(kernels B1 and B2 on the card), a sharded density-control round and a
rebalance of the store across its blocks.
"""

from __future__ import annotations

import torch


def _tiny_setup(size=32, n_gaussians=96, n_frames=3, n_virtual=2, backend="auto",
                device="cuda"):
    """(dataset, cfg, scene, params) of the reference's tiny model: 128
    Gaussian slots, SH degree 1, MLP CRF of 8 units, 8x16 tiles, on the
    reference's default synthetic fixture (the oracle's ground truth)."""
    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import dataset as dataset_mod
    from casualhdrsplat_torch.models import image_formation as imf

    cfg = config.ModelConfig(
        max_gaussians=128,
        sh_degree=1,
        num_virtual_views=n_virtual,
        crf=config.CRFConfig(kind="mlp", hidden=8),
        rasterize=config.RasterizeConfig(
            tile_h=8, tile_w=16, tile_capacity=64, max_tiles_per_gaussian=32,
            chunk=32, backend=backend,
        ),
    )
    ds = dataset_mod.make_synthetic_dataset(
        seed=0, device=device, renderer="oracle", n_gaussians=n_gaussians,
        n_frames=n_frames, n_virtual=2, size=size,
    )
    scene = imf.build_scene(ds, cfg, device=device)
    params = imf.init_params(scene, ds.points_xyz, ds.points_rgb, cfg,
                             torch.Generator().manual_seed(0))
    return ds, cfg, scene, params


def entry(device="cuda"):
    """(fn, example_args): the forward step of the flagship model, the
    blurred LDR frame of frame 1.  On the card `fn` replays a CUDA graph
    (`image_formation.GraphedRenders`, captured on its second call), the
    counterpart of the reference's jitted forward; it takes no gradient."""
    from casualhdrsplat_torch.models import image_formation as imf

    _, cfg, scene, params = _tiny_setup(device=device)
    renders = imf.GraphedRenders()

    def forward_step(params, frame_id):
        return renders.render_frame_blurred(params, scene, frame_id, cfg)

    return forward_step, (params, 1)


def _dryrun_rank(rank, device, n_devices):
    """One rank of `dryrun_multichip`: the reference's dry run on this
    rank's block.  Returns what the parent prints and checks."""
    import numpy as np

    from casualhdrsplat_torch import config
    from casualhdrsplat_torch.data import dataset as dataset_mod
    from casualhdrsplat_torch.ops import rasterize_packed as rp
    from casualhdrsplat_torch.parallel.mesh import GAUSS_AXIS
    from casualhdrsplat_torch.train.trainer import Trainer

    gauss = 2 if n_devices % 2 == 0 else 1
    cfg = config.TrainConfig(name="dryrun-multichip")
    cfg.model.max_gaussians = 256
    cfg.model.sh_degree = 1
    cfg.model.num_virtual_views = 2
    cfg.model.crf = config.CRFConfig(kind="mlp", hidden=8)
    cfg.model.rasterize = config.RasterizeConfig(
        tile_h=8, tile_w=16, tile_capacity=64, max_tiles_per_gaussian=16,
        chunk=32, backend="pallas", packed=True, shared_binning=False,
        stream_factor=8,
    )
    cfg.parallel = config.ParallelConfig(data=n_devices // gauss, gauss=gauss)
    cfg.densify.enabled = True
    cfg.densify.start_iter = 1
    cfg.densify.interval = 2
    cfg.densify.grad_threshold = 1e-8  # force clone/split activity
    cfg.densify.opacity_reset_interval = 10**9
    cfg.data.eval_every = 0

    ds = dataset_mod.make_synthetic_dataset(seed=0, device=device, renderer="oracle",
                                            n_gaussians=96, n_frames=3, n_virtual=2, size=32)
    t = Trainer(cfg, ds, device=device)
    alive0 = int(t._shard_counts().sum())
    fwd0, bwd0 = rp.FWD_KERNEL.launches, rp.BWD_KERNEL.launches
    stats = {}
    for _ in range(3):
        out = t.run_step()
        stats = out if "alive" in out else stats
    if not (np.isfinite(out["loss"]) and stats and stats["alive"] > alive0):
        raise AssertionError(f"dryrun_multichip: loss {out['loss']}, alive {alive0} -> {stats}")
    before = t._shard_counts()
    if t.mesh.size(GAUSS_AXIS) > 1:
        t._rebalance()
    after = t._shard_counts()
    if after.sum() != before.sum() or np.ptp(after) > np.ptp(before):
        raise AssertionError(f"dryrun_multichip: rebalance {before} -> {after}")
    return {
        "mesh": dict(t.mesh.shape), "loss": out["loss"], "alive0": alive0,
        "alive": stats["alive"], "before": before.tolist(), "after": after.tolist(),
        "block": tuple(t.params["gaussians"]["means"].shape),
        "capacity": cfg.model.max_gaussians,
        "launches": (rp.FWD_KERNEL.launches - fwd0, rp.BWD_KERNEL.launches - bwd0),
        "collectives": dict(t.mesh.stats),
    }


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> list:
    """Full sharded training on an n-rank (data x gauss) mesh, gauss = 2
    when n is even: 3 steps through the production Trainer (the packed
    rasterizer over the mesh, per-view binning, a density-control round
    every 2 steps at grad_threshold 1e-8, so that it clones and splits),
    then a rebalance of the store across its blocks.  The ranks run in
    processes of this machine (parallel.launch), on `device` ("cuda":
    rank r on card r % cards; "cpu"), over `backend` (default nccl on the
    card, gloo on the CPU; two ranks on one card need gloo).  Raises on a
    failed check; prints the reference's summary line and returns every
    rank's result."""
    from casualhdrsplat_torch.parallel import launch
    from casualhdrsplat_torch.parallel.distributed import backend_for

    results = launch.spawn(_dryrun_rank, n_devices, backend_for(device, backend), device,
                           args=(n_devices,))
    r = results[0]
    kernels = "cuda" if torch.device(device).type == "cuda" else "plain"
    print(f"dryrun_multichip ok: mesh={r['mesh']} backend=packed-{kernels} "
          f"loss={r['loss']:.5f} alive {r['alive0']}->{r['alive']} (densified) "
          f"shard_counts {r['before']}->{r['after']} (rebalanced) "
          f"means block={list(r['block'])} of {r['capacity']}", flush=True)
    return results


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["multichip"]:
        # python -m casualhdrsplat_torch.entry multichip N [cuda|cpu] [gloo|nccl]
        argv = sys.argv[2:] + [None] * 3
        dryrun_multichip(int(argv[0] or 2), device=argv[1] or "cuda", backend=argv[2])
    else:
        fn, args = entry()
        with torch.no_grad():
            out = fn(*args)
        print("entry ok:", tuple(out.shape), float(out.mean()))
