"""Adaptive density control on the fixed-capacity store: the in-step half.
Counterpart of casualhdrsplat_tpu/train/densify.py (`AdcState`,
`accumulate`, `screen_prune_active`).

Screen-space gradient statistics are accumulated from the rasterizer's
`means2d_offset` gradient tap between ADC rounds.  The rounds themselves
(`densify_and_prune`, `reset_opacity`) are not ported yet: ROADMAP.md,
queue A, "The rest of training".
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from casualhdrsplat_torch.config import DensifyConfig


class AdcState(NamedTuple):
    grad_accum: torch.Tensor  # [N] sum of ||d loss / d means2d|| per round
    count: torch.Tensor  # [N] int32 visibility count
    max_radii: torch.Tensor  # [N] max screen radius (pixels) this round

    @staticmethod
    def zero(n: int, device="cuda") -> "AdcState":
        return AdcState(
            grad_accum=torch.zeros((n,), dtype=torch.float32, device=device),
            count=torch.zeros((n,), dtype=torch.int32, device=device),
            max_radii=torch.zeros((n,), dtype=torch.float32, device=device),
        )


def accumulate(
    state: AdcState,
    means2d_grad: torch.Tensor,
    radii: torch.Tensor,
    image_size: Optional[Tuple[int, int]] = None,
) -> AdcState:
    """Update the per-Gaussian statistics after one training step.

    means2d_grad: [N,2] pixel-space d loss / d means2d; radii: [V,N] (0
    where culled); image_size: (width, height) scales the pixel-space
    gradient by [w/2, h/2] to the NDC-half-extent convention the lineage's
    `grad_threshold` constant assumes.
    """
    r = radii.amax(0)
    visible = r > 0
    if image_size is not None:
        w, h = image_size
        means2d_grad = means2d_grad * torch.tensor(
            [0.5 * w, 0.5 * h], dtype=means2d_grad.dtype, device=means2d_grad.device
        )
    g = torch.linalg.norm(means2d_grad, dim=-1)
    return AdcState(
        grad_accum=state.grad_accum + torch.where(visible, g, 0.0),
        count=state.count + visible.to(torch.int32),
        max_radii=torch.maximum(state.max_radii, r),
    )


def screen_prune_active(step: int, cfg: DensifyConfig) -> bool:
    """Whether the max-screen-radius prune applies at `step`: from
    cfg.screen_prune_from when set, else only after the first opacity
    reset, once opacities are informative."""
    if cfg.screen_prune_from > 0:
        return step >= cfg.screen_prune_from
    return step > cfg.opacity_reset_interval
