"""Per-group Adam and its schedules.  Counterpart of
casualhdrsplat_tpu/train/optim.py (an optax.multi_transform over the
parameter tree).

The optimizer state is a plain tree of tensors aligned with the parameter
dict, {"count": int, "mu": tree, "nu": tree}, so that densification can
edit it with the masked writes it applies to the parameters
(`zero_state_at`).  Every group steps together, so one update count serves
all of them.  `alive` belongs to the frozen group: it has no moments and
never changes.

`Optimizer.update` writes the parameters and the moments in place (the
reference returns new trees): at 131,072 Gaussians the SH coefficients and
their two moments are the largest tensors of a training process.

The learning rates and the bias corrections are evaluated on the device,
in float32, from a device copy of the update count, as optax does inside
the reference's jitted step: a step captured as a CUDA graph
(utils/cuda_graphs.py) then reads the count from its buffer, where a
Python number would be frozen into the graph.  `state["count"]` stays the
host's count (checkpoints, the trainer's bookkeeping); `Optimizer.apply`
takes the device count, `update` fills one from the host count.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple, Union

import torch

from casualhdrsplat_torch.config import OptimConfig

# A constant, or a function of the count of updates already made: a
# Python int gives a Python float (evaluated in float32, as on the device),
# an int32 count tensor a float32 tensor on its device.
Schedule = Union[float, Callable]

_GAUSSIAN_GROUPS = {
    "means": "means",
    "quats": "quats",
    "log_scales": "scales",
    "opacity_logit": "opacities",
    "sh_dc": "sh_dc",
    "sh_rest": "sh_rest",
    "alive": "frozen",
}
_ADAM_B2 = 0.999
_ADAM_EPS = 1e-15


def _label_tree(params: Dict[str, Any]):
    """Tree of group labels matching the parameter structure."""
    return {
        "gaussians": {k: _GAUSSIAN_GROUPS[k] for k in params["gaussians"]},
        "knot_deltas": "pose",
        "log_exposures": "exposure",
        "crf": {k: "crf" for k in params["crf"]},
    }


def labelled_leaves(params: Dict[str, Any]) -> Iterator[Tuple[Tuple[str, ...], str, Any]]:
    """(path, group label, leaf) of every parameter leaf."""
    for key, label in _label_tree(params).items():
        if isinstance(label, dict):
            for sub, sub_label in label.items():
                yield (key, sub), sub_label, params[key][sub]
        else:
            yield (key,), label, params[key]


def tree_get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def tree_set(tree, path, value) -> None:
    """tree[path] = value, making the dicts on the way."""
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _schedule(fn) -> Schedule:
    """A schedule from `fn`, a function of an int32 count tensor."""

    def schedule(count):
        if isinstance(count, torch.Tensor):
            return fn(count)
        return float(fn(torch.tensor(count, dtype=torch.int32)))

    return schedule


def _exp_sched(init: float, final: float, steps: int) -> Schedule:
    """Exponential decay init -> final over `steps` updates
    (optax.exponential_decay, in float32); a zero init freezes the
    group."""
    if init <= 0.0:
        return 0.0
    rate = final / init
    return _schedule(
        lambda count: torch.where(count <= 0, init, init * torch.pow(rate, count / steps)))


def pose_schedule(cfg: OptimConfig) -> Schedule:
    """Pose-group lr schedule: warm-up at zero, exponential decay, and an
    optional restart of the decay clock at cfg.pose_lr_rewarm_step.  Like
    every schedule here it is evaluated at the 0-based count of updates
    already made."""
    base = _exp_sched(
        cfg.pose_lr_init, cfg.pose_lr_final,
        max(cfg.max_steps - cfg.pose_warmup_steps, 1),
    )
    if not callable(base):
        return base
    warmup = cfg.pose_warmup_steps
    if warmup > 0:
        decay = base
        # after the warm-up the decay sees count - warmup
        base = _schedule(
            lambda count: torch.where(count < warmup, 0.0, decay(count - warmup)))
    if cfg.pose_lr_rewarm_step > 0:
        # A boundary at or inside the warm-up window would give the
        # restarted branch a nonzero lr on steps the warm-up should freeze.
        if cfg.pose_lr_rewarm_step <= warmup:
            raise ValueError(
                f"pose_lr_rewarm_step ({cfg.pose_lr_rewarm_step}) must be "
                f"> pose_warmup_steps ({warmup})"
            )
        boundary, before = cfg.pose_lr_rewarm_step, base
        # past the boundary, the schedule as if the warm-up had just ended
        # `count - boundary` updates ago
        return _schedule(lambda count: torch.where(
            count < boundary, before(count), before(warmup + (count - boundary))))
    return base


class _Group:
    def __init__(self, lr: Schedule, b1: float = 0.9, trans_scale: float = 1.0):
        self.lr, self.b1, self.trans_scale = lr, b1, trans_scale

    def lr_at(self, count: int) -> float:
        return float(self.lr(count)) if callable(self.lr) else float(self.lr)

    def step_scale(self, count: torch.Tensor):
        """-lr at the device count: a float32 tensor, or a Python float
        for a constant rate (optax's scale(-lr))."""
        return -self.lr(count) if callable(self.lr) else -float(self.lr)


class Optimizer:
    """Adam per parameter group (b2 = 0.999, eps = 1e-15, bias-corrected,
    as optax.adam)."""

    def __init__(self, groups: Dict[str, _Group]):
        self.groups = groups
        self._counts: Dict[torch.device, torch.Tensor] = {}

    def count_buffer(self, device) -> torch.Tensor:
        """This optimizer's int32 count buffer on `device`."""
        device = torch.device(device)
        if device not in self._counts:
            self._counts[device] = torch.zeros((), dtype=torch.int32, device=device)
        return self._counts[device]

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        state: Dict[str, Any] = {"count": 0, "mu": {"crf": {}}, "nu": {"crf": {}}}
        for path, label, leaf in labelled_leaves(params):
            if label != "frozen":
                tree_set(state["mu"], path, torch.zeros_like(leaf))
                tree_set(state["nu"], path, torch.zeros_like(leaf))
        return state

    def learning_rates(self, count: int) -> Dict[str, float]:
        return {label: g.lr_at(count) for label, g in self.groups.items()}

    @torch.no_grad()
    def update(self, grads, state, params) -> Dict[str, Any]:
        """One Adam update of every floating leaf, in place: `params` and
        the moments of `state` are written; the returned state is `state`
        with its count raised by one."""
        leaf = next(iter(params["gaussians"].values()))
        count = self.count_buffer(leaf.device).fill_(state["count"])
        self.apply(grads, state, params, count)
        state["count"] += 1
        return state

    @torch.no_grad()
    def apply(self, grads, state, params, count: torch.Tensor) -> None:
        """The device half of `update`: one Adam update of every floating
        leaf at the int32 device `count` of updates already made (the
        schedules' argument; the bias corrections take count + 1), with no
        host read and no Python number that changes from step to step.
        Leaves `state["count"]` to the caller."""
        t = (count + 1).float()
        corrections = {}
        for path, label, leaf in labelled_leaves(params):
            if label == "frozen":
                continue
            group = self.groups[label]
            if label not in corrections:
                # optax's bias_correction: 1 - b ** count, in float32
                corrections[label] = (1.0 - torch.pow(group.b1, t), 1.0 - torch.pow(_ADAM_B2, t),
                                      group.step_scale(count))
            bc1, bc2, scale = corrections[label]
            grad = tree_get(grads, path)
            mu, nu = tree_get(state["mu"], path), tree_get(state["nu"], path)
            mu.mul_(group.b1).add_(grad, alpha=1.0 - group.b1)
            nu.mul_(_ADAM_B2).addcmul_(grad, grad, value=1.0 - _ADAM_B2)
            mu_hat = mu / bc1
            nu_hat = nu / bc2
            step = mu_hat.div_(nu_hat.sqrt_().add_(_ADAM_EPS)).mul_(scale)
            if group.trans_scale != 1.0:
                # a per-half learning rate: columns 3:6 of [M, 6] knot
                # deltas are the translation
                step[..., 3:] *= group.trans_scale
            leaf.add_(step)


def make_optimizer(cfg: OptimConfig, scene_extent: float = 1.0) -> Optimizer:
    means_sched = _exp_sched(
        cfg.means_lr_init * scene_extent, cfg.means_lr_final * scene_extent,
        cfg.max_steps,
    )
    return Optimizer({
        "means": _Group(means_sched),
        "quats": _Group(cfg.quats_lr),
        "scales": _Group(cfg.scales_lr),
        "opacities": _Group(cfg.opacities_lr),
        "sh_dc": _Group(cfg.sh_dc_lr),
        "sh_rest": _Group(cfg.sh_dc_lr / cfg.sh_rest_lr_div),
        "pose": _Group(pose_schedule(cfg), b1=cfg.pose_b1,
                       trans_scale=cfg.pose_trans_lr_scale),
        "exposure": _Group(cfg.exposure_lr, b1=cfg.exposure_b1),
        "crf": _Group(cfg.crf_lr),
    })


@torch.no_grad()
def zero_state_at(opt_state, mask: torch.Tensor):
    """Zero the Adam moments at masked Gaussian slots after clone, split or
    prune, in place: every floating state leaf whose leading dimension is
    the Gaussian capacity."""

    def visit(node):
        if isinstance(node, dict):
            for child in node.values():
                visit(child)
        elif (isinstance(node, torch.Tensor) and node.dim() >= 1
              and node.shape[0] == mask.shape[0] and node.is_floating_point()):
            # a masked fill, not node[mask] = 0 (which finds the mask's
            # nonzeros on the host): a captured density-control round holds it
            node.masked_fill_(mask.reshape(mask.shape + (1,) * (node.dim() - 1)), 0.0)

    visit(opt_state)
    return opt_state
