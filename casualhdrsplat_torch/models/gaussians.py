"""Gaussian parameter store with fixed-capacity padding.

Counterpart of casualhdrsplat_tpu/models/gaussians.py: the store is
allocated once at `max_gaussians` capacity with an `alive` mask, as a dict
of tensors.  Activation: scales = exp(log_scales), opacity =
sigmoid(logit) (0 for dead slots), quats normalized on use, SH -> linear
HDR radiance via ops/sh.py.  `project` takes the store to the
compositor's payload rows: on CPU tensors through `activate`,
`colors_for_view` and the plain projection chain, on CUDA tensors through
kernel P1 (ops/projection_fused.py), which does all of it in one pass.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from casualhdrsplat_torch.ops import projection_fused
from casualhdrsplat_torch.ops import sh as sh_ops
from casualhdrsplat_torch.ops.knn import knn_mean_dist
from casualhdrsplat_torch.ops.projection import Projected, view_directions

Params = Dict[str, torch.Tensor]


def inverse_sigmoid(x: float) -> float:
    return float(np.log(x / (1.0 - x)))


def create(
    xyz: np.ndarray,
    rgb: np.ndarray,
    max_gaussians: int,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    scale_clip=(1e-7, 1e2),
    device="cuda",
) -> Params:
    """Initialize from SfM points: the k-NN scale init (ops/knn.py, the
    host grid search; on `device`'s rule for its fallback), the rest
    host-side numpy, then one copy."""
    n = min(len(xyz), max_gaussians)
    k = sh_ops.num_sh_bases(sh_degree)
    xyz = np.asarray(xyz, np.float32)[:n]
    rgb = np.asarray(rgb, np.float32)[:n]
    dist = np.clip(knn_mean_dist(xyz, 3, device=device).cpu().numpy(), *scale_clip)

    means = np.zeros((max_gaussians, 3), np.float32)
    means[:n] = xyz
    log_scales = np.full((max_gaussians, 3), -10.0, np.float32)
    log_scales[:n] = np.log(dist)[:, None]
    quats = np.zeros((max_gaussians, 4), np.float32)
    quats[:, 0] = 1.0
    opacity = np.full((max_gaussians,), -15.0, np.float32)  # dead slots ~ 0
    opacity[:n] = inverse_sigmoid(init_opacity)
    sh_dc = np.zeros((max_gaussians, 1, 3), np.float32)
    sh_dc[:n, 0] = sh_ops.rgb_to_sh_dc(torch.from_numpy(rgb)).numpy()
    sh_rest = np.zeros((max_gaussians, k - 1, 3), np.float32)
    alive = np.zeros((max_gaussians,), bool)
    alive[:n] = True

    store = {
        "means": means, "quats": quats, "log_scales": log_scales,
        "opacity_logit": opacity, "sh_dc": sh_dc, "sh_rest": sh_rest,
        "alive": alive,
    }
    return {k: torch.as_tensor(v, device=device) for k, v in store.items()}


class Activated(NamedTuple):
    means3d: torch.Tensor  # [N,3]
    quats: torch.Tensor  # [N,4] (normalized downstream)
    scales: torch.Tensor  # [N,3] positive
    opacities: torch.Tensor  # [N] in (0,1), 0 for dead slots
    sh: torch.Tensor  # [N,K,3]


def activate(params: Params) -> Activated:
    return Activated(
        means3d=params["means"],
        quats=params["quats"],
        scales=torch.exp(params["log_scales"]),
        opacities=torch.sigmoid(params["opacity_logit"]) * params["alive"],
        sh=torch.cat([params["sh_dc"], params["sh_rest"]], dim=1),
    )


def colors_for_view(act: Activated, camtoworld: torch.Tensor, degree: int) -> torch.Tensor:
    """Per-Gaussian linear HDR radiance for one camera pose [N,3], or for a
    batch of poses [V,4,4] -> [V,N,3]."""
    dirs = view_directions(act.means3d, camtoworld)
    return sh_ops.eval_sh(degree, act.sh, dirs)


def project(
    store: Params,
    viewmats: torch.Tensor,  # [V, 4, 4] world to camera
    camtoworlds: Optional[torch.Tensor],  # [4, 4] (one for every view) or [V, 4, 4]
    sh_degree: int,
    fx, fy, cx, cy,
    width: int,
    height: int,
    near_plane: float = 0.05,
    antialias: bool = False,
    colors: Optional[torch.Tensor] = None,  # [N, 3] or [1 or V, N, 3]
    means2d_offset: Optional[torch.Tensor] = None,  # [N, 2]
) -> Tuple[torch.Tensor, Projected]:
    """The payload [V, N + 1, 16] of the store seen from `viewmats`, and
    its projection (means2d, depths, conics, radii, valid [V, N, ...]):
    SH radiance at `sh_degree` from the camera centres of `camtoworlds`
    (one centre: a radiance every view shares), or `colors` where given
    (then `camtoworlds` is not read), the projection, the offset added to
    the means2d, the dead and invisible slots culled.  Differentiable in
    every floating leaf, the matrices and the offset."""
    viewmats = viewmats.reshape(-1, 4, 4)
    if viewmats.device.type == "cuda":
        return projection_fused.project_leaves(
            store["means"], store["quats"], store["log_scales"], store["opacity_logit"],
            store["alive"], store["sh_dc"], store["sh_rest"], sh_degree, camtoworlds, viewmats,
            fx, fy, cx, cy, width, height, near_plane=near_plane, antialias=antialias,
            colors=colors, means2d_offset=means2d_offset)
    return project_chain(store, viewmats, camtoworlds, sh_degree, fx, fy, cx, cy, width,
                         height, near_plane, antialias, colors, means2d_offset)


def project_geometry(store: Params, viewmats: torch.Tensor, fx, fy, cx, cy, width: int,
                     height: int, near_plane: float = 0.05,
                     antialias: bool = False) -> Projected:
    """Where the store's Gaussians fall in each view of `viewmats`:
    `project`'s means2d, depths, radii and valid flags [V, N], for the
    start-up checks that read no colour (the trainer's footprint guard,
    models/image_formation.py `shared_binning_demand`).  Zero colours stand
    in for the SH term, and the payload rows written beside them are
    dropped: 64 bytes a view and Gaussian, ~67 MB at 8 views of 131,072
    (~0.02 ms of an H100's bandwidth), in checks that run before the first
    step."""
    viewmats = viewmats.reshape(-1, 4, 4)
    colors = torch.zeros((1,) + store["means"].shape, dtype=store["means"].dtype,
                         device=viewmats.device)
    return project(store, viewmats, None, 0, fx, fy, cx, cy, width, height,
                   near_plane=near_plane, antialias=antialias, colors=colors)[1]


def project_chain(store: Params, viewmats, camtoworlds, sh_degree: int, fx, fy, cx, cy,
                  width: int, height: int, near_plane: float = 0.05, antialias: bool = False,
                  colors: Optional[torch.Tensor] = None,
                  means2d_offset: Optional[torch.Tensor] = None):
    """`project` as the plain chain, on any device (the CPU path, and the
    card tests' yardstick): `activate`, `colors_for_view`, then
    ops/projection_fused.py `payload_chain`."""
    viewmats = viewmats.reshape(-1, 4, 4)
    act = activate(store)
    if colors is None:
        colors = colors_for_view(act, camtoworlds, sh_degree)
    if colors.dim() == 2:
        colors = colors.expand((viewmats.shape[0],) + colors.shape)
    return projection_fused.payload_chain(
        act.means3d, act.quats, act.scales, act.opacities, colors, viewmats, fx, fy, cx, cy,
        width, height, near_plane=near_plane, antialias=antialias,
        means2d_offset=means2d_offset)
