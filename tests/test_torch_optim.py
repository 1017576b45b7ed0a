"""Port parity: train/optim.py (per-group Adam, the schedules,
`zero_state_at`) against the reference's optax.multi_transform, and
`convert.opt_state_from_jax`.

Tolerances: learning rates rtol 1e-6 (both evaluate a schedule in
float32, with their own pow); parameters and moments after N updates
from the same gradients atol 1e-6 * scale + rtol 2e-5, scale = the
leaf's largest magnitude: two Adam implementations that round the bias
corrections and the square root at different places."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch.train import optim as t_optim
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.train import optim as j_optim

N, KNOTS, FRAMES, HIDDEN = 6, 5, 3, 4


def _np_params(rng):
    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {
        "gaussians": {
            "means": f(N, 3), "quats": f(N, 4), "log_scales": f(N, 3),
            "opacity_logit": f(N), "sh_dc": f(N, 1, 3), "sh_rest": f(N, 3, 3),
            "alive": np.array([1, 1, 0, 1, 1, 0], bool),
        },
        "knot_deltas": f(KNOTS, 6) * 0.01,
        "log_exposures": f(FRAMES),
        "crf": {"unit_k": f(3, HIDDEN), "unit_c": f(3, HIDDEN), "unit_w": f(3, HIDDEN),
                "gain": f(3), "bias": f(3)},
    }


def _np_grads(rng, params, step):
    """Gradients of mixed magnitude; sparse for the pose and exposure
    groups (one frame a step touches one spline support)."""
    grads = jax.tree.map(
        lambda p: (rng.normal(size=p.shape) * 10.0 ** rng.integers(-4, 1)).astype(np.float32),
        params)
    grads["gaussians"]["alive"] = np.zeros(N, bool)
    mask = np.zeros((KNOTS, 1), np.float32)
    mask[step % KNOTS] = 1.0
    grads["knot_deltas"] *= mask
    grads["log_exposures"] *= (np.arange(FRAMES) == step % FRAMES)
    return grads


def _to_torch(tree):
    return convert.params_from_jax(tree, device="cpu")


def _adam_states(opt_state):
    """optax's ScaleByAdamState of every group, as numpy trees: the input
    of convert.opt_state_from_jax."""
    groups = {}
    for label, masked in opt_state.inner_states.items():
        adam = [s for s in jax.tree.leaves(
            masked.inner_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)]
        if not adam:
            continue  # the frozen group

        def unmask(tree):
            out = {}
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                node = out
                keys = [p.key for p in path]
                for key in keys[:-1]:
                    node = node.setdefault(key, {})
                node[keys[-1]] = np.asarray(leaf)
            return out

        groups[label] = {"count": int(adam[0].count), "mu": unmask(adam[0].mu),
                         "nu": unmask(adam[0].nu)}
    return groups


def _assert_tree_close(t_tree, j_tree, what, like):
    """Every floating leaf of two trees shaped like the parameters `like`
    (moment trees have no leaf for the frozen group)."""
    for path, label, _ in t_optim.labelled_leaves(like):
        if label == "frozen":
            continue
        leaf = t_optim.tree_get(t_tree, path)
        ref = np.asarray(t_optim.tree_get(j_tree, path))
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(leaf.numpy(), ref, atol=1e-6 * scale, rtol=2e-5,
                                   err_msg=f"{what} {path}")


OPTIM_CASES = {
    "defaults": dict(max_steps=40),
    "warmup_trans_scale_b1": dict(max_steps=40, pose_warmup_steps=3, pose_trans_lr_scale=0.25,
                                  pose_b1=0.0, exposure_b1=0.0),
    "rewarm": dict(max_steps=40, pose_warmup_steps=2, pose_lr_rewarm_step=5,
                   pose_trans_lr_scale=2.0),
    "frozen_pose": dict(max_steps=40, pose_lr_init=0.0, pose_lr_rewarm_step=4),
}


@pytest.mark.parametrize("case", list(OPTIM_CASES))
def test_adam_updates_match_optax(rng, case):
    kw = OPTIM_CASES[case]
    params = _np_params(rng)
    extent = 2.5
    opt_j = j_optim.make_optimizer(j_config.OptimConfig(**kw), extent)
    j_params = jax.tree.map(jnp.asarray, params)
    j_state = opt_j.init(j_params)

    @jax.jit
    def step_j(p, s, g):
        updates, s = opt_j.update(g, s, p)
        p = jax.tree.map(
            lambda a, u: a + u if jnp.issubdtype(a.dtype, jnp.floating) else a, p, updates)
        return p, s

    opt_t = t_optim.make_optimizer(t_config.OptimConfig(**kw), extent)
    t_params = _to_torch(params)
    t_state = opt_t.init(t_params)
    assert "alive" not in t_state["mu"]["gaussians"]
    for step in range(8):
        grads = _np_grads(rng, params, step)
        j_params, j_state = step_j(j_params, j_state, jax.tree.map(jnp.asarray, grads))
        t_state = opt_t.update(_to_torch(grads), t_state, t_params)
    assert t_state["count"] == 8
    _assert_tree_close(t_params, j_params, "params", t_params)
    np.testing.assert_array_equal(t_params["gaussians"]["alive"].numpy(),
                                  params["gaussians"]["alive"])
    # the reference's state, carried over, equals the port's own
    carried = convert.opt_state_from_jax(_adam_states(j_state), t_params)
    assert carried["count"] == 8
    for moment in ("mu", "nu"):
        _assert_tree_close(t_state[moment], carried[moment], moment, t_params)
    if case == "frozen_pose":
        np.testing.assert_array_equal(t_params["knot_deltas"].numpy(), params["knot_deltas"])


@pytest.mark.parametrize("kw,boundary", [
    (dict(max_steps=50, pose_warmup_steps=7), 7),
    (dict(max_steps=50, pose_warmup_steps=4, pose_lr_rewarm_step=20), 20),
    (dict(max_steps=50, pose_lr_rewarm_step=9), 9),
])
def test_schedules_match_optax(kw, boundary):
    """The learning rate of updates 0, 1, boundary - 1, boundary and
    boundary + 1 (0-based count of updates already made), and the last."""
    sched_j = j_optim.pose_schedule(j_config.OptimConfig(**kw))
    sched_t = t_optim.pose_schedule(t_config.OptimConfig(**kw))
    means_j = j_optim._exp_sched(1.6e-4 * 3, 1.6e-6 * 3, 50)
    means_t = t_optim._exp_sched(1.6e-4 * 3, 1.6e-6 * 3, 50)
    for count in (0, 1, boundary - 1, boundary, boundary + 1, 49):
        np.testing.assert_allclose(sched_t(count), float(sched_j(count)), rtol=1e-6,
                                   atol=0, err_msg=str(count))
        np.testing.assert_allclose(means_t(count), float(means_j(count)), rtol=1e-6)
    if kw.get("pose_warmup_steps"):
        assert sched_t(kw["pose_warmup_steps"] - 1) == 0.0
        assert sched_t(kw["pose_warmup_steps"]) == pytest.approx(1e-3)
    if kw.get("pose_lr_rewarm_step"):
        assert sched_t(boundary) == pytest.approx(1e-3)  # full lr again
        assert sched_t(boundary - 1) < 1e-3


def test_schedule_corner_cases():
    assert t_optim._exp_sched(0.0, 1e-5, 10) == 0.0  # a zero init freezes the group
    assert t_optim.pose_schedule(t_config.OptimConfig(pose_lr_init=0.0)) == 0.0
    with pytest.raises(ValueError, match="pose_lr_rewarm_step"):
        t_optim.pose_schedule(t_config.OptimConfig(pose_warmup_steps=10,
                                                   pose_lr_rewarm_step=10))
    opt = t_optim.make_optimizer(t_config.OptimConfig(max_steps=100), scene_extent=2.0)
    lrs = opt.learning_rates(0)
    assert lrs["means"] == pytest.approx(3.2e-4)
    assert lrs["sh_rest"] == pytest.approx(2.5e-3 / 20)
    assert opt.learning_rates(100)["means"] == pytest.approx(3.2e-6)


def test_zero_state_at_matches_reference(rng):
    params = _np_params(rng)
    opt_j = j_optim.make_optimizer(j_config.OptimConfig(max_steps=10))
    j_params = jax.tree.map(jnp.asarray, params)
    grads = _np_grads(rng, params, 0)
    _, j_state = opt_j.update(jax.tree.map(jnp.asarray, grads), opt_j.init(j_params), j_params)
    opt_t = t_optim.make_optimizer(t_config.OptimConfig(max_steps=10))
    t_params = _to_torch(params)
    t_state = opt_t.update(_to_torch(grads), opt_t.init(t_params), t_params)
    mask = np.array([0, 1, 0, 0, 1, 0], bool)
    j_state = j_optim.zero_state_at(j_state, "gaussians", jnp.asarray(mask))
    t_state = t_optim.zero_state_at(t_state, torch.from_numpy(mask))
    carried = convert.opt_state_from_jax(_adam_states(j_state), t_params)
    for moment in ("mu", "nu"):
        for key, leaf in t_state[moment]["gaussians"].items():
            assert float(leaf[mask].abs().max()) == 0.0
            assert float(leaf[~mask].abs().max()) > 0.0
            np.testing.assert_allclose(leaf.numpy(), carried[moment]["gaussians"][key].numpy(),
                                       rtol=2e-5, atol=1e-12)
        # leaves of another leading size are left alone (KNOTS != N)
        assert float(t_state[moment]["knot_deltas"].abs().max()) > 0.0
