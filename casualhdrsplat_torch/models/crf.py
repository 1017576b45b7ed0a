"""Learnable camera response function F_theta.  Counterpart of
casualhdrsplat_tpu/models/crf.py.

A per-channel monotone MLP over normalized log-exposure: softplus-
reparameterized nonnegative weights and monotone activations make every
learned response a valid CRF by construction.  Applied pointwise to
[..., 3] images.

Kinds: "identity" (clip(E, 0, 1)), "gamma" (fixed gamma curve), "mlp"
(learnable).  The "mlp" chain runs as one fused pass
(ops/crf_fused.py: kernel T1 on the card, its plain version and
closed-form backward on the CPU).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from casualhdrsplat_torch.config import CRFConfig
from casualhdrsplat_torch.ops import crf_fused

Params = Dict[str, torch.Tensor]

_EPS = 1e-8


def _inv_softplus(y: float) -> float:
    return float(np.log(np.expm1(y)))


def create(
    cfg: CRFConfig,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Params:
    """Initialize the monotone mixture near a plausible camera curve.

    cfg.init_gamma > 0: pre-fit the mixture to that gamma curve with a
    short Adam loop (deterministic given `generator`).  0: an s-curve
    approximating clip(E, 0, 1).  The unit-weight jitter is drawn from
    `generator` (a CPU generator; a fixed seed when None), so it differs
    from the reference's jax.random draw.
    """
    if cfg.kind != "mlp":
        return {}
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    c, h = 3, cfg.hidden
    # sigmoid(gain*(x - x0)) with gain ~ 1.32*span, x0 at E~0.35
    # approximates clip(E, 0, 1) over the normalized log range
    span = cfg.log_max - cfg.log_min
    gain = 1.32 * span
    x0 = (np.log(0.35) - cfg.log_min) / span
    params = {
        "unit_k": torch.ones((c, h)),
        "unit_c": torch.linspace(0.05, 0.95, h).repeat(c, 1),
        "unit_w": torch.full((c, h), -4.0)
        + 0.01 * torch.randn((c, h), generator=generator),
        "gain": torch.full((c,), _inv_softplus(gain)),
        "bias": torch.full((c,), -gain * x0),
    }
    params = {k: v.to(device) for k, v in params.items()}
    if cfg.init_gamma > 0.0:
        params = _prefit_to_gamma(params, cfg)
    return params


def _prefit_to_gamma(params: Params, cfg: CRFConfig, steps: int = 1200) -> Params:
    """Fit the mixture to clip(E,0,1)^(1/init_gamma) on 256 log-spaced
    samples with torch.optim.Adam(lr=1e-2) (the reference uses optax.adam
    with the same defaults).  Returns new, detached tensors."""
    dev = params["unit_k"].device
    with torch.inference_mode(False), torch.enable_grad():
        p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        e = torch.exp(torch.linspace(cfg.log_min, cfg.log_max, 256, device=dev))
        target = torch.clamp(e, 0.0, 1.0) ** (1.0 / cfg.init_gamma)
        e3 = e[:, None].repeat(1, 3)
        opt = torch.optim.Adam(list(p.values()), lr=1e-2)
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((apply(p, e3, cfg) - target[:, None]) ** 2)
            loss.backward()
            opt.step()
    return {k: v.detach() for k, v in p.items()}


def apply(params: Params, hdr_exposed: torch.Tensor, cfg: CRFConfig) -> torch.Tensor:
    """Map exposed HDR radiance E = H * dt ([..., 3], linear) to LDR in
    [0, 1]."""
    if cfg.kind == "mlp":
        # _monotone_mlp(params, _norm_log(max(E, 0), cfg)), fused
        return crf_fused.monotone_crf(
            hdr_exposed, F.softplus(params["unit_k"]) * 20.0, params["unit_c"],
            F.softplus(params["unit_w"]), F.softplus(params["gain"]), params["bias"],
            cfg.log_min, cfg.log_max)
    e = torch.clamp(hdr_exposed, min=0.0)
    if cfg.kind == "identity":
        return torch.clamp(e, 0.0, 1.0)
    # gamma: a linear ramp below eps keeps the curve's slope finite at 0
    y = torch.clamp(e, 0.0, 1.0)
    eps = 1e-4
    inv_g = 1.0 / cfg.gamma
    safe = torch.clamp(y, min=eps)
    return torch.where(y > eps, safe**inv_g, y * eps ** (inv_g - 1.0))


def response_curve(params: Params, cfg: CRFConfig, num: int = 256, device="cuda"):
    """Sampled CRF: log-spaced exposures -> LDR."""
    if params:
        device = params["unit_k"].device
    e = torch.exp(torch.linspace(cfg.log_min, cfg.log_max, num, device=device))
    return e, apply(params, e[:, None].repeat(1, 3), cfg)


def smoothness_prior(params: Params, cfg: CRFConfig, num: int = 64) -> torch.Tensor:
    """Second-difference penalty on the response curve."""
    if cfg.kind != "mlp":
        return torch.zeros(())
    _, ldr = response_curve(params, cfg, num)
    d2 = ldr[2:] - 2.0 * ldr[1:-1] + ldr[:-2]
    return torch.mean(d2 * d2) * num**2


def chroma_prior(params: Params, cfg: CRFConfig, num: int = 64) -> torch.Tensor:
    """Penalize divergence between the per-channel response curves.

    The joint model has a chromatic gauge: a CRF whose channels drift apart
    can be compensated by oppositely tinted splat colours, leaving training
    renders unchanged while both estimates walk away from the truth.
    Penalizing the cross-channel variance of the sampled curve pins the
    gauge without constraining the curve's shape."""
    if cfg.kind != "mlp":
        return torch.zeros(())
    _, ldr = response_curve(params, cfg, num)  # [num, 3]
    dev = ldr - ldr.mean(-1, keepdim=True)
    return torch.mean(dev * dev)


def _norm_log(e: torch.Tensor, cfg: CRFConfig) -> torch.Tensor:
    return (torch.log(e + _EPS) - cfg.log_min) / (cfg.log_max - cfg.log_min)


def _monotone_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Per-channel monotone one-hidden-layer MLP: a positive mixture of
    sigmoid units sigma(k_j (x - c_j)) plus a positive linear skip, through
    an output sigmoid."""
    batch_shape = x.shape[:-1]
    xc = x.reshape(-1, 3).T[:, :, None]  # [3, B, 1]
    k = F.softplus(params["unit_k"])[:, None, :] * 20.0  # [3,1,H]
    w = F.softplus(params["unit_w"])[:, None, :]
    c = params["unit_c"][:, None, :]
    y = (w * torch.sigmoid(k * (xc - c))).sum(-1)  # [3,B]
    y = y + F.softplus(params["gain"])[:, None] * xc[..., 0] + params["bias"][:, None]
    # stretch slightly past [0,1] then clip so exact black/white is reachable
    out = torch.sigmoid(y) * 1.004 - 0.002
    return torch.clamp(out, 0.0, 1.0).T.reshape(*batch_shape, 3)
