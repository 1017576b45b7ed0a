"""Readable plain reference renderer.  Counterpart of
casualhdrsplat_tpu/ops/oracle.py.

A small, obviously correct, fully autodiffable implementation of project ->
depth sort -> alpha-composite that the rasterizers (ops/rasterize.py) are
tested against.  Dense over [N_gaussians, H*W]; use only on small scenes.

Compositing semantics (the framework's behavioural contract):
  alpha_k = min(alpha_clip, opacity_k * exp(-sigma_k)),  zeroed when
            alpha_k < alpha_threshold or the Gaussian is culled;
  over all Gaussians in ascending depth order:
  C(u)    = sum_k c_k alpha_k T_k,  T_k = prod_{j<k} (1 - alpha_j)
  out     = C + T_final * background
There is no per-pixel early stop in the math; the rasterizers may skip work
only where it changes the result by less than transmittance_eps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from casualhdrsplat_torch.ops.projection import Projected, project_gaussians


class RenderOutput(NamedTuple):
    image: torch.Tensor  # [H, W, 3] linear HDR radiance
    alpha: torch.Tensor  # [H, W] 1 - final transmittance
    # per-Gaussian max composited weight, for visibility pruning
    max_weight: torch.Tensor  # [N]


def composite(
    proj: Projected,  # one view: every leaf [N, ...]
    colors: torch.Tensor,  # [N, 3]
    opacities: torch.Tensor,  # [N] activated, in (0, 1)
    width: int,
    height: int,
    background: Optional[torch.Tensor] = None,
    alpha_clip: float = 0.99,
    alpha_threshold: float = 1.0 / 255.0,
) -> RenderOutput:
    n = proj.means2d.shape[0]
    dev = proj.means2d.device
    inf = torch.full_like(proj.depths, float("inf"))
    # stable, as jnp.argsort: culled Gaussians tie at +inf
    order = torch.argsort(torch.where(proj.valid, proj.depths, inf), stable=True)
    means2d = proj.means2d[order]
    conics = proj.conics[order]
    valid = proj.valid[order]
    op = (opacities * proj.compensation)[order]
    col = colors[order]

    # pixel centres at integer coordinates + 0.5
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    px = (xs + 0.5).to(torch.float32).reshape(-1)
    py = (ys + 0.5).to(torch.float32).reshape(-1)

    dx = px[None, :] - means2d[:, 0:1]  # [N, P]
    dy = py[None, :] - means2d[:, 1:2]
    sigma = 0.5 * (conics[:, 0:1] * dx * dx + conics[:, 2:3] * dy * dy) \
        + conics[:, 1:2] * dx * dy
    alpha = op[:, None] * torch.exp(-torch.clamp(sigma, min=0.0))
    alpha = torch.clamp(alpha, max=alpha_clip)
    alpha = torch.where((alpha >= alpha_threshold) & valid[:, None], alpha, 0.0)

    # exclusive product of (1 - alpha) down the depth order
    one_minus = 1.0 - alpha
    through = torch.cumprod(one_minus, dim=0)
    T = torch.cat([torch.ones((1, alpha.shape[1]), device=dev), through[:-1]], dim=0)
    w = alpha * T  # [N, P]
    img = (w[:, :, None] * col[:, None, :]).sum(0)  # [P, 3]
    t_final = through[-1] if n > 0 else torch.ones_like(px)
    if background is not None:
        img = img + t_final[:, None] * background[None, :]
    if n > 0:
        max_w = torch.empty(n, device=dev).index_copy_(0, order, w.detach().amax(1))
    else:
        max_w = torch.zeros((0,), device=dev)
    return RenderOutput(
        image=img.reshape(height, width, 3),
        alpha=(1.0 - t_final).reshape(height, width),
        max_weight=max_w,
    )


def render(
    means3d,
    quats,
    scales,
    opacities,
    colors,
    camera,
    background=None,
    near_plane: float = 0.05,
    antialias: bool = False,
) -> RenderOutput:
    """Full reference pipeline: project, then composite.  `colors` are
    [N,3] per-Gaussian radiance (SH already evaluated by the caller)."""
    proj = project_gaussians(
        means3d, quats, scales, camera.viewmat, camera.fx, camera.fy,
        camera.cx, camera.cy, camera.width, camera.height,
        near_plane=near_plane, antialias=antialias,
    )
    return composite(proj, colors, opacities, camera.width, camera.height, background)
