"""Carry the reference's parameters, optimizer state and scene into the
port.

All take plain numpy data (the caller converts the reference's arrays
with `np.asarray`), so this module needs nothing of the reference.  With
them both packages compute the same thing from the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from casualhdrsplat_torch.models.image_formation import SceneStatic

_GAUSSIAN_KEYS = ("means", "quats", "log_scales", "opacity_logit", "sh_dc",
                  "sh_rest", "alive")
_CRF_KEYS = ("unit_k", "unit_c", "unit_w", "gain", "bias")


def params_from_jax(np_params: dict, device="cuda") -> dict:
    """The reference's parameter tree, as numpy arrays, -> the port's
    parameter dict: gaussians.{means, quats, log_scales, opacity_logit,
    sh_dc, sh_rest, alive}, knot_deltas, log_exposures and crf.{unit_k,
    unit_c, unit_w, gain, bias} (an empty crf for the non-learnable
    kinds).  Floats become float32 tensors; `alive` stays bool."""

    def tensor(a, dtype=np.float32):
        return torch.as_tensor(np.array(a, dtype=dtype), device=device)

    g = np_params["gaussians"]
    gaussians = {k: tensor(g[k]) for k in _GAUSSIAN_KEYS if k != "alive"}
    gaussians["alive"] = tensor(g["alive"], bool)
    crf = np_params.get("crf") or {}
    return {
        "gaussians": gaussians,
        "knot_deltas": tensor(np_params["knot_deltas"]),
        "log_exposures": tensor(np_params["log_exposures"]),
        "crf": {k: tensor(crf[k]) for k in _CRF_KEYS if k in crf},
    }


def scene_from_numpy(scene, device="cuda") -> SceneStatic:
    """Any object with the reference SceneStatic's fields (base_knots,
    knot_t0, knot_dt, timestamps, fx, fy, cx, cy as array-likes; width,
    height as ints) -> the port's SceneStatic."""

    def tensor(name):
        return torch.as_tensor(np.array(getattr(scene, name), np.float32), device=device)

    return SceneStatic(
        **{f: tensor(f) for f in ("base_knots", "knot_t0", "knot_dt", "timestamps",
                                  "fx", "fy", "cx", "cy")},
        width=int(scene.width),
        height=int(scene.height),
    )


def adc_from_numpy(grad_accum, count, max_radii, device="cuda"):
    """The reference's density-control statistics (AdcState's three fields
    as array-likes) -> the port's AdcState."""
    from casualhdrsplat_torch.train.densify import AdcState

    return AdcState(
        grad_accum=torch.as_tensor(np.array(grad_accum, np.float32), device=device),
        count=torch.as_tensor(np.array(count, np.int32), device=device),
        max_radii=torch.as_tensor(np.array(max_radii, np.float32), device=device),
    )


def opt_state_from_jax(np_groups: dict, params: dict) -> dict:
    """The reference's optimizer state -> the port's (train/optim.py).

    `np_groups` maps every optimizer group label ("means", "quats",
    "scales", "opacities", "sh_dc", "sh_rest", "pose", "exposure", "crf")
    to its Adam state {"count": int, "mu": tree, "nu": tree}, each tree
    holding numpy arrays at that group's leaves of the parameter tree (and
    nothing elsewhere): optax keeps one such state per group.  `params` is
    the port's parameter dict: it gives the structure and the device.  The
    groups step together, so their counts must agree.
    """
    from casualhdrsplat_torch.train import optim

    counts = {int(g["count"]) for g in np_groups.values()}
    if len(counts) != 1:
        raise ValueError(f"optimizer groups disagree on the update count: {sorted(counts)}")
    state = optim.Optimizer({}).init(params)
    state["count"] = counts.pop()
    for path, label, leaf in optim.labelled_leaves(params):
        if label == "frozen":
            continue
        for moment in ("mu", "nu"):
            value = np.array(optim.tree_get(np_groups[label][moment], path), np.float32)
            optim.tree_get(state[moment], path).copy_(
                torch.as_tensor(value, device=leaf.device))
    return state
