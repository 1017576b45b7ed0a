"""Gaussian parameter store with fixed-capacity padding.

Counterpart of casualhdrsplat_tpu/models/gaussians.py: the store is
allocated once at `max_gaussians` capacity with an `alive` mask, as a dict
of tensors.  Activation: scales = exp(log_scales), opacity =
sigmoid(logit) (0 for dead slots), quats normalized on use, SH -> linear
HDR radiance via ops/sh.py.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from casualhdrsplat_torch.ops import sh as sh_ops
from casualhdrsplat_torch.ops.knn import knn_mean_dist
from casualhdrsplat_torch.ops.projection import view_directions

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
    """Initialize from SfM points: the k-NN scale init on `device`, the
    rest host-side numpy, then one copy."""
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
