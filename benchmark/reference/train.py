"""The plain reference of a training step: the loss of the blurred frame
against the captured one, autograd's gradient, Adam per parameter group
with its schedules, the screen-space statistics and the prune-only
density-control round.

Plain float32 PyTorch.  The semantics it follows:
- loss = 0.8 L1 + 0.2 (1 - SSIM) / 2 (Gaussian 11x11 window, sigma 1.5,
  no padding, SSIM's moments unclamped), + 1e-3 (mean log exposure -
  its initial value)^2 + 1e-3 the CRF's second-difference penalty on 64
  samples (times 64^2) + 1e-2 its cross-channel variance; |d| has the
  gradient +1 at d = 0;
- Adam (b2 0.999, eps 1e-15, bias-corrected, float32 schedules evaluated
  at the count of updates already made): means' rate decays
  exponentially from 1.6e-4 to 1.6e-6 times the scene extent over
  max_steps, the poses' from 1e-3 to 1e-5; the rest are constant;
- statistics: per Gaussian the largest screen radius over the views;
- the round (prune only, screen prune armed): a slot dies when its
  opacity is under prune_opacity or its largest radius since the last
  round exceeds prune_screen_radius times the image diagonal; a dead
  slot's Adam moments are zeroed, its parameters kept.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import render as ref

# parameter leaves, in a fixed order, and the Adam group of each
LEAVES = (
    (("gaussians", "means"), "means"), (("gaussians", "quats"), "quats"),
    (("gaussians", "log_scales"), "scales"), (("gaussians", "opacity_logit"), "opacities"),
    (("gaussians", "sh_dc"), "sh_dc"), (("gaussians", "sh_rest"), "sh_rest"),
    (("knot_deltas",), "pose"), (("log_exposures",), "exposure"),
    (("crf", "unit_k"), "crf"), (("crf", "unit_c"), "crf"), (("crf", "unit_w"), "crf"),
    (("crf", "gain"), "crf"), (("crf", "bias"), "crf"),
)


def leaf_name(path) -> str:
    return ".".join(path)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _conv(img, kernel, pad):
    """Separable cross-correlation of [C, H, W] with a 1-D kernel along H
    then W, zero padding `pad`."""
    c, k = img.shape[0], kernel.shape[0]
    x = F.conv2d(img[None], kernel.reshape(1, 1, k, 1).expand(c, 1, k, 1), padding=(pad, 0),
                 groups=c)
    return F.conv2d(x, kernel.reshape(1, 1, 1, k).expand(c, 1, 1, k), padding=(0, pad),
                    groups=c)[0]


def ssim(a, b):
    """Mean SSIM of two [H, W, 3] images (moments unclamped)."""
    x = torch.arange(11, dtype=torch.float32, device=a.device) - 5
    g = torch.exp(-(x ** 2) / (2 * 1.5 ** 2))
    g = g / g.sum()

    def blur(img):
        return _conv(img.permute(2, 0, 1), g, 0).permute(1, 2, 0)

    mu_a, mu_b = blur(a), blur(b)
    aa, bb, ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    var_a, var_b, cov = blur(a * a) - aa, blur(b * b) - bb, blur(a * b) - ab
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return torch.mean((2 * ab + c1) / (aa + bb + c1) * (2 * cov + c2) / (var_a + var_b + c2))


def loss_fn(params, scene, frame, target, init_log_exposures, cfg, sh_degree, offset):
    """(loss, RasterOut) of one training frame."""
    model, lw = cfg["model"], cfg["loss"]
    pred, out = ref.render_frame(params, scene, frame, model, sh_degree, offset)
    d = pred - target
    photo = ((1.0 - lw["ssim_lambda"]) * torch.mean(torch.where(d >= 0, d, -d))
             + lw["ssim_lambda"] * (1.0 - ssim(pred, target)) / 2.0)
    loss = photo + lw["exposure_prior_weight"] * torch.mean(
        params["log_exposures"] - init_log_exposures) ** 2
    curve = ref.response_curve(params["crf"], model["crf"], 64)
    d2 = curve[2:] - 2.0 * curve[1:-1] + curve[:-2]
    loss = loss + lw["crf_smoothness_weight"] * torch.mean(d2 * d2) * 64 ** 2
    dev = curve - curve.mean(-1, keepdim=True)
    return loss + lw["crf_chroma_weight"] * torch.mean(dev * dev), out


def _decay(init: float, final: float, steps: int, count: torch.Tensor):
    return torch.where(count <= 0, init, init * torch.pow(final / init, count / steps))


def learning_rates(cfg: dict, scene_extent: float, count: int, device) -> dict:
    """Each group's rate at `count` updates made, in float32."""
    o = cfg["optim"]
    c = torch.tensor(count, dtype=torch.int32, device=device)
    return {
        "means": _decay(o["means_lr_init"] * scene_extent, o["means_lr_final"] * scene_extent,
                        o["max_steps"], c),
        "pose": _decay(o["pose_lr_init"], o["pose_lr_final"], max(o["max_steps"], 1), c),
        "quats": o["quats_lr"], "scales": o["scales_lr"], "opacities": o["opacities_lr"],
        "sh_dc": o["sh_dc_lr"], "sh_rest": o["sh_dc_lr"] / o["sh_rest_lr_div"],
        "exposure": o["exposure_lr"], "crf": o["crf_lr"],
    }


def _b1(cfg: dict, group: str) -> float:
    o = cfg["optim"]
    return {"pose": o["pose_b1"], "exposure": o["exposure_b1"]}.get(group, 0.9)


@torch.no_grad()
def adam(params, mu, nu, grads, cfg, scene_extent: float, count: int):
    """One Adam update of every leaf, in place."""
    lrs = learning_rates(cfg, scene_extent, count, params["log_exposures"].device)
    t = torch.tensor(float(count + 1), device=params["log_exposures"].device)
    for path, group in LEAVES:
        b1 = _b1(cfg, group)
        g = grads[leaf_name(path)]
        m, v = mu[leaf_name(path)], nu[leaf_name(path)]
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(0.999).addcmul_(g, g, value=1.0 - 0.999)
        m_hat = m / (1.0 - torch.pow(b1, t))
        v_hat = v / (1.0 - torch.pow(0.999, t))
        get(params, path).add_(m_hat / (torch.sqrt(v_hat) + 1e-15) * -lrs[group])


def scene_extent(points: np.ndarray) -> float:
    """The 97th percentile of the points' distances from their centroid."""
    center = points.mean(axis=0)
    return float(np.quantile(np.linalg.norm(points - center, axis=1), 0.97))


@torch.no_grad()
def prune_round(params, mu, nu, max_radii, cfg, diag: float):
    """The prune-only round with the screen prune armed: the slots it kills."""
    g = params["gaussians"]
    d = cfg["densify"]
    prune = g["alive"] & ((torch.sigmoid(g["opacity_logit"]) < d["prune_opacity"])
                          | (max_radii > d["prune_screen_radius"] * diag))
    g["alive"] &= ~prune
    for path, _ in LEAVES[:6]:
        for state in (mu, nu):
            x = state[leaf_name(path)]
            x.masked_fill_(prune.reshape(prune.shape + (1,) * (x.dim() - 1)), 0.0)
    return prune


def screen_prune_armed(step: int, d: dict) -> bool:
    """Whether the screen-size prune is on at `step`: from
    screen_prune_from, or else after the first opacity reset."""
    if d["screen_prune_from"] > 0:
        return step >= d["screen_prune_from"]
    return step > d["opacity_reset_interval"]


class Trainer:
    """The reference's training state and step, from a given state."""

    def __init__(self, params, mu, nu, scene, images, init_log_exposures, cfg, extent, count,
                 step):
        self.params, self.mu, self.nu = params, mu, nu
        self.scene, self.images, self.cfg = scene, images, cfg
        self.init_log_exposures = init_log_exposures
        self.extent, self.count, self.step = extent, count, step
        n = params["gaussians"]["alive"].shape[0]
        self.max_radii = torch.zeros(n, device=images.device)
        self.diag = ref.image_diag(scene.cam[4], scene.cam[5])

    def sh_degree(self) -> int:
        return min(self.step // self.cfg["densify"]["sh_degree_interval"],
                   self.cfg["model"]["sh_degree"])

    def run_step(self, frame: int):
        """One step on `frame`: (loss, gradient of every leaf by name)."""
        leaves = {}
        p = {"gaussians": dict(self.params["gaussians"]), "crf": {}}
        for path, _ in LEAVES:
            leaf = get(self.params, path).detach().requires_grad_(True)
            leaves[leaf_name(path)] = leaf
            (p["gaussians"] if path[0] == "gaussians" else p["crf"] if path[0] == "crf"
             else p)[path[-1]] = leaf
        n = self.max_radii.shape[0]
        offset = torch.zeros((n, 2), device=self.images.device, requires_grad=True)
        loss, out = loss_fn(p, self.scene, frame, self.images[frame], self.init_log_exposures,
                            self.cfg, self.sh_degree(), offset)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                     allow_unused=True)))
        grads = {k: torch.zeros_like(leaves[k]) if v is None else v for k, v in grads.items()}
        adam(self.params, self.mu, self.nu, grads, self.cfg, self.extent, self.count)
        self.count += 1
        self.step += 1
        self.max_radii = torch.maximum(self.max_radii, out.radii.amax(0))
        d = self.cfg["densify"]
        in_window = d["start_iter"] <= self.step <= d["stop_iter"]
        if d["enabled"] and not in_window and screen_prune_armed(self.step, d) \
                and self.step % d["interval"] == 0:
            prune_round(self.params, self.mu, self.nu, self.max_radii, self.cfg, self.diag)
            self.max_radii = torch.zeros_like(self.max_radii)
        return float(loss.detach()), grads


def exposure_init(n_frames: int, device) -> torch.Tensor:
    """The log exposures' anchor: 0 (exposure_init_frac 0)."""
    return torch.zeros(n_frames, device=device)


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)
