"""The port's single-device entry point.  Counterpart of the reference's
`__graft_entry__.entry()`:

    fn, args = entry()        # device="cuda"; pass device="cpu" for a CPU run
    blurred = fn(*args)       # render_frame(...).blurred_ldr, [32, 32, 3]

`fn` is the forward of the full image-formation chain (spline virtual
poses, batched HDR rasterization through kernel B1, CRF, blur mean) on a
tiny synthetic scene.  The multi-device dry run waits for the `parallel/`
slice (ROADMAP.md queue A).
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
    blurred LDR frame of frame 1."""
    from casualhdrsplat_torch.models import image_formation as imf

    _, cfg, scene, params = _tiny_setup(device=device)

    def forward_step(params, frame_id):
        return imf.render_frame(params, scene, frame_id, cfg).blurred_ldr

    return forward_step, (params, 1)


if __name__ == "__main__":
    fn, args = entry()
    with torch.no_grad():
        out = fn(*args)
    print("entry ok:", tuple(out.shape), float(out.mean()))
