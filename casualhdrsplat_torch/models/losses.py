"""Training losses.  Counterpart of casualhdrsplat_tpu/models/losses.py:
L1 + D-SSIM on the synthesized blurred LDR frame against the captured
frame, plus the gauge-fixing priors that make the joint HDR x exposure x
CRF optimization well-posed.  Images are [H, W, 3].

The convolutions must run in full float32: SSIM forms E[x^2] - E[x]^2,
which cancels catastrophically under a reduced-precision product (the
reference measured SSIM > 1.3 and garbage pose gradients with bf16
convolutions).  cuDNN would take TF32 for a float32 convolution by default;
the package switches that off once, in casualhdrsplat_torch/__init__.py.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # |d| written as a select so that its gradient at d == 0 is +1, the
    # reference's (jnp.abs); torch.abs gives 0 there.  Exact ties are
    # common: a black target under a render clipped to exactly 0.
    d = a - b
    return torch.mean(torch.where(d >= 0, d, -d))


def _separable_conv(chw: torch.Tensor, kernel: torch.Tensor, pad: int) -> torch.Tensor:
    """Depthwise separable convolution of a [C, H, W] image with the 1-D
    `kernel` along H then W (cross-correlation, as lax.conv), zero-padded
    by `pad` on every side."""
    c = chw.shape[0]
    k = kernel.shape[0]
    x = chw[None]
    x = F.conv2d(x, kernel.reshape(1, 1, k, 1).expand(c, 1, k, 1), padding=(pad, 0), groups=c)
    x = F.conv2d(x, kernel.reshape(1, 1, 1, k).expand(c, 1, 1, k), padding=(0, pad), groups=c)
    return x[0]


def _ssim_cs(a, b, window: int = 11, sigma: float = 1.5, clamp: bool = True):
    """Shared SSIM internals: mean SSIM and mean contrast-structure (cs)
    over an [H,W,3] pair.  cs is the luminance-free factor MS-SSIM needs
    at its coarse scales."""
    c1, c2 = 0.01**2, 0.03**2
    x = torch.arange(window, dtype=torch.float32, device=a.device) - window // 2
    g = torch.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()

    def blur(img):  # VALID: no padding
        return _separable_conv(img.permute(2, 0, 1), g, 0).permute(1, 2, 0)

    mu_a, mu_b = blur(a), blur(b)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a = blur(a * a) - mu_aa
    var_b = blur(b * b) - mu_bb
    cov = blur(a * b) - mu_ab
    if clamp:
        # E[x^2] - E[x]^2 cancels in float32 on near-flat bright windows,
        # giving negative variances and per-pixel SSIM > 1.  Clamp the
        # variances at zero and the covariance by Cauchy-Schwarz; the bound
        # is a numerical projection, so no gradient flows through it.
        var_a = torch.clamp(var_a, min=0.0)
        var_b = torch.clamp(var_b, min=0.0)
        lim = torch.sqrt(torch.clamp(var_a * var_b, min=1e-24)).detach()
        cov = torch.maximum(torch.minimum(cov, lim), -lim)
    cs = (2 * cov + c2) / (var_a + var_b + c2)
    lum = (2 * mu_ab + c1) / (mu_aa + mu_bb + c1)
    return torch.mean(lum * cs), torch.mean(cs)


def ssim(a, b, window: int = 11, sigma: float = 1.5, clamp: bool = True):
    """Mean SSIM over an [H,W,3] pair (Gaussian 11x11 window, the constants
    of the 3DGS lineage).  Differentiable.

    clamp=True (reported metrics) bounds the float32 moment cancellation
    that otherwise yields SSIM > 1 on near-flat bright windows.  The
    training loss uses clamp=False, the lineage's exact formulation."""
    return _ssim_cs(a, b, window, sigma, clamp)[0]


# Wang et al. 2003 per-scale weights, shared by every MS-SSIM implementation.
MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim(a: torch.Tensor, b: torch.Tensor, scales: int = 5) -> torch.Tensor:
    """Multi-scale SSIM over an [H,W,3] pair, the 5-scale Wang-2003
    formulation: contrast-structure at every scale, luminance only at the
    coarsest, combined as a weighted geometric mean.  Scales the image is
    too small to support (min side < 11 px after halving) are dropped and
    the weights renormalized."""
    feasible = 1
    side = min(a.shape[0], a.shape[1])
    while feasible < scales and (side // 2) >= 11:
        side //= 2
        feasible += 1
    scales = min(scales, feasible)
    weights = torch.tensor(MS_SSIM_WEIGHTS[:scales], device=a.device)
    weights = weights / weights.sum()

    def half(img):  # 2x2 average pool, VALID
        return F.avg_pool2d(img.permute(2, 0, 1)[None], 2)[0].permute(1, 2, 0)

    vals = []
    for s in range(scales):
        full, cs = _ssim_cs(a, b, clamp=True)
        vals.append(full if s == scales - 1 else cs)
        if s != scales - 1:
            a, b = half(a), half(b)
    # cs can be slightly negative on adversarial pairs; clamp before the
    # fractional power
    vals = torch.clamp(torch.stack(vals), min=1e-6)
    return torch.exp(torch.sum(weights * torch.log(vals)))


def d_ssim(a, b):
    return (1.0 - ssim(a, b, clamp=False)) / 2.0


def photometric(pred, target, ssim_lambda: float):
    """(1-l) L1 + l D-SSIM, the 3DGS photometric loss."""
    return (1.0 - ssim_lambda) * l1(pred, target) + ssim_lambda * d_ssim(pred, target)


def gaussian_blur(img: torch.Tensor, sigma, k: int = 33) -> torch.Tensor:
    """Separable Gaussian blur (SAME, zero-padded) of an [H, W, 3] image.
    `sigma` may be a tensor, so one code path (and no host read) covers a
    whole coarse-to-fine schedule; sigma <= 1e-2 degenerates to an exact
    delta kernel, the identity.

    Blurring both the render and the target early widens the pose-alignment
    basin to about sigma pixels; annealing sigma to 0 restores the
    full-detail objective."""
    kk = k if k % 2 == 1 else k + 1
    r = (kk - 1) // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32, device=img.device)
    sig = torch.clamp(torch.as_tensor(sigma, dtype=torch.float32, device=img.device),
                      min=1e-3)
    w = torch.where(sig > 1e-2, torch.exp(-0.5 * (x / sig) ** 2), (x == 0).float())
    w = w / w.sum()
    return _separable_conv(img.permute(2, 0, 1), w, r).permute(1, 2, 0)


def exposure_prior(log_exposures: torch.Tensor, log_init: torch.Tensor) -> torch.Tensor:
    """Pin the global exposure scale: the product HDR x dt x CRF has a
    gauge freedom; anchoring mean log-exposure to its init removes it."""
    return torch.mean(log_exposures - log_init) ** 2


def psnr(a, b, max_val: float = 1.0):
    mse = torch.mean((a - b) ** 2)
    return 20.0 * math.log10(max_val) - 10.0 * torch.log10(torch.clamp(mse, min=1e-12))
