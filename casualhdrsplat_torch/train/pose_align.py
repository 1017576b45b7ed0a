"""Test-time pose alignment for deblurred-render evaluation.  Counterpart
of casualhdrsplat_tpu/train/pose_align.py.

The joint problem (trajectory, exposures, CRF and scene all free) can
converge with the camera trajectory a few degrees off the ground truth in
a deformation that is not a similarity (scene and spline co-warp); the
deblurred render is then misaligned with the sharp ground-truth frame and
raw PSNR measures the misalignment, not sharpness.  The standard protocol
of pose-free novel-view synthesis (BARF, BAD-NeRF's test-time pose
optimisation) optimises a small per-image camera correction against the
evaluation target before scoring, with the scene frozen: 6 DoF against
the frame's pixels cannot manufacture sharpness, only remove the offset.

The reference runs the descent as one jitted `lax.scan`; here it is a
loop of `steps` autograd steps on the se(3) correction alone, with Adam at
optax's defaults (b1 0.9, b2 0.999, eps 1e-8).  The loss values are kept
on the device and read once, after the loop.
"""

from __future__ import annotations

import torch

from casualhdrsplat_torch.geometry import lie
from casualhdrsplat_torch.models import image_formation as imf
from casualhdrsplat_torch.models import losses

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _frozen(tree):
    """The parameter tree with every tensor detached: the scene, CRF and
    exposures take no gradient."""
    if isinstance(tree, dict):
        return {k: _frozen(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def _adam_descent(loss_fn, x0: torch.Tensor, steps: int, lr: float):
    """`steps` Adam steps on x from x0 (optax.adam's update, its float32
    arithmetic included: the bias corrections 1 - b ** count are evaluated
    in float32, where 1 - 0.999 is 1.3e-5 off the exact value; in Python
    floats the first step moves x 7e-6 of lr further than optax's, enough
    for an 8-step descent to part from the reference's on a steep loss);
    returns the final x and the loss before each step [steps]."""
    x = x0.detach().clone()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    curve = []
    for count in range(1, steps + 1):
        x.requires_grad_(True)
        val = loss_fn(x)
        grad, = torch.autograd.grad(val, x)
        with torch.no_grad():
            mu = _B1 * mu + (1.0 - _B1) * grad
            nu = _B2 * nu + (1.0 - _B2) * (grad * grad)
            t = torch.full((), count, dtype=torch.float32, device=x.device)
            mu_hat = mu / (1.0 - torch.pow(_B1, t))
            nu_hat = nu / (1.0 - torch.pow(_B2, t))
            x = x.detach() + mu_hat / (torch.sqrt(nu_hat) + _EPS) * -lr
        curve.append(val.detach())
    return x, torch.stack(curve) if curve else x.new_zeros((0,))


def make_window_realigner(cfg, steps: int = 48, lr: float = 2e-3, sh_degree=None,
                          knot_support: int = 7):
    """Per-window pose restart: block-coordinate refinement of one frame's
    trajectory window against its blurry captured frame (training data
    only).  One se(3) correction `d` is left-composed (camera frame) onto
    the `knot_support` knots whose cubic support overlaps the frame's
    exposure window, with scene, CRF and exposure frozen, and baked into
    the returned knot deltas (new_delta = log(exp(d) @ exp(delta)), the
    composition of image_formation.effective_knots), so ordinary joint
    training continues from the restarted window.

    At either end of the trajectory the clipped window names a knot more
    than once.  The reference's `kd.at[idx].set(upd)` then writes the knot
    once and gives `d` the gradient of that one write; a scatter of every
    copy would count it once per copy.  So the window's knots are taken
    once each (their updates are equal: the same row, the same `d`).

    Returns `realign(params, scene, frame_id, target) -> (knot_deltas, d,
    loss_curve)`."""

    def realign(params, scene, frame_id: int, target):
        params = _frozen(params)
        kd = params["knot_deltas"]
        t_i = scene.timestamps[frame_id]
        j0 = torch.floor((t_i - scene.knot_t0) / scene.knot_dt).to(torch.int64) - 1
        idx = torch.clamp(j0 + torch.arange(knot_support, device=kd.device),
                          0, kd.shape[0] - 1)
        knots = torch.unique(idx)

        def with_delta(d):
            upd = lie.se3_log(lie.mat_mul(lie.se3_exp(d), lie.se3_exp(kd[knots])))
            return {**params, "knot_deltas": kd.index_put((knots,), upd)}

        def loss_fn(d):
            out = imf.render_frame(with_delta(d), scene, frame_id, cfg, sh_degree=sh_degree)
            return losses.l1(out.blurred_ldr, target)

        d, curve = _adam_descent(loss_fn, torch.zeros(6, device=kd.device), steps, lr)
        with torch.no_grad():
            return with_delta(d)["knot_deltas"], d, curve

    return realign


def make_aligner(cfg, steps: int = 48, lr: float = 2e-3, sh_degree=None):
    """Returns `align(params, scene, viewmat0, exposure, target) ->
    (aligned_ldr, delta, loss_curve)`: Adam on an se(3) delta applied to
    the eval viewmat (left-composed), minimising the mean squared error of
    the render at `exposure` against `target`.  `cfg` is the ModelConfig."""

    def align(params, scene, viewmat0, exposure, target):
        params = _frozen(params)

        def render(delta):
            vm = lie.mat_mul(lie.se3_exp(delta), viewmat0)
            ldr, _, _ = imf.render_pose(params, scene, vm, cfg, exposure=exposure,
                                        sh_degree=sh_degree)
            return ldr

        def loss_fn(delta):
            return torch.mean(torch.square(render(delta) - target))

        delta, curve = _adam_descent(loss_fn, torch.zeros(6, device=viewmat0.device),
                                     steps, lr)
        with torch.no_grad():
            return render(delta), delta, curve

    return align
