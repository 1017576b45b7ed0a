"""Port parity: train/densify.py (`densify_and_prune`, `reset_opacity`) and
the density-control rounds of train/trainer.py against the JAX package.

The split noise is the reference's own: the test draws jax.random.normal
from the key the reference is given and feeds the same numbers to the
port's `densify_and_prune_with_noise`.  With that a round is a sequence of
comparisons, selects and copies plus one rotation of the noise, so every
leaf agrees to atol 1e-6 (the rotation's float32 sums), `alive`, the
report and the zeroed moments exactly.

Both trainers, six steps on a dense config through two densify rounds, an
opacity reset and a prune-only round, with splits disabled (the two
trainers draw different noise): the reports equal, `alive` equal, and the
parameters within 2e-2 lr of the reference's, the tolerance the packed
trainers are held to after five steps (tests/test_torch_train_step.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.train import densify as t_densify
from casualhdrsplat_torch.train import optim as t_optim
from casualhdrsplat_torch.train.trainer import Trainer as TorchTrainer
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.data import dataset as j_dataset
from casualhdrsplat_tpu.train import densify as j_densify
from casualhdrsplat_tpu.train import optim as j_optim
from casualhdrsplat_tpu.train.trainer import Trainer as JaxTrainer

CAP = 48


def _store(rng, n_alive):
    """A numpy parameter tree whose store has every kind of Gaussian: small
    and large, faint and opaque, dead slots in between."""
    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)

    alive = np.zeros(CAP, bool)
    alive[rng.permutation(CAP)[:n_alive]] = True
    return {
        "gaussians": {
            "means": f(CAP, 3), "quats": f(CAP, 4),
            "log_scales": np.log(10.0 ** rng.uniform(-3.5, -0.5, size=(CAP, 3))
                                 ).astype(np.float32),
            "opacity_logit": (f(CAP) * 3.0 - 2.0), "sh_dc": f(CAP, 1, 3),
            "sh_rest": f(CAP, 3, 3), "alive": alive,
        },
        "knot_deltas": f(4, 6) * 0.01,
        "log_exposures": f(2),
        "crf": {},
    }


def _adc(rng):
    return (rng.uniform(0, 2e-3, size=CAP).astype(np.float32),
            rng.integers(0, 4, size=CAP).astype(np.int32),
            rng.uniform(0, 30, size=CAP).astype(np.float32))


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


ADC_CASES = {
    # name: (alive slots, DensifyConfig overrides, screen_prune, prune_only)
    "clone_and_split": (30, dict(), False, False),
    "clone_only": (30, dict(split_scale_threshold_rel=1e3), False, False),
    "split_only": (30, dict(split_scale_threshold_rel=0.0), False, False),
    "prune_opacity": (30, dict(prune_opacity=0.3, grad_threshold=1.0), False, False),
    "screen_prune": (30, dict(prune_screen_radius=0.1), True, False),
    "prune_only": (30, dict(prune_screen_radius=0.1), True, True),
    "capacity_exhaustion": (44, dict(grad_threshold=1e-5), False, False),
    "full_store": (48, dict(grad_threshold=1e-5), True, False),
}


@pytest.mark.parametrize("case", list(ADC_CASES))
def test_densify_and_prune_matches_jax(case):
    n_alive, overrides, screen_prune, prune_only = ADC_CASES[case]
    rng = np.random.default_rng(list(ADC_CASES).index(case))
    params, adc = _store(rng, n_alive), _adc(rng)
    cfg_j, cfg_t = j_config.DensifyConfig(**overrides), t_config.DensifyConfig(**overrides)
    extent, diag = 1.7, 100.0

    # one Adam update first, so that the moments are not zero
    j_params = jax.tree.map(jnp.asarray, params)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    grads["gaussians"]["alive"] = np.zeros(CAP, bool)
    opt_j = j_optim.make_optimizer(j_config.OptimConfig())
    _, j_state = opt_j.update(jax.tree.map(jnp.asarray, grads), opt_j.init(j_params), j_params)
    t_params = convert.params_from_jax(params, device="cpu")
    t_state = convert.opt_state_from_jax(_adam_states(j_state), t_params)

    key = jax.random.PRNGKey(7)
    out_j, j_state, adc_j, rep_j = j_densify.densify_and_prune(
        j_params["gaussians"], j_state, j_densify.AdcState(*map(jnp.asarray, adc)), key,
        cfg_j, extent, diag, screen_prune=screen_prune, prune_only=prune_only)
    eps1, eps2 = np.asarray(jax.random.normal(key, (2, CAP, 3)))
    out_t, t_state, adc_t, rep_t = t_densify.densify_and_prune_with_noise(
        t_params["gaussians"], t_state, convert.adc_from_numpy(*adc, device="cpu"),
        torch.from_numpy(eps1), torch.from_numpy(eps2), cfg_t, extent, diag,
        screen_prune=screen_prune, prune_only=prune_only)

    report = tuple(int(x) for x in rep_t)
    assert report == tuple(int(x) for x in rep_j), report
    cloned, split, pruned, alive = report
    expect = {
        "clone_and_split": cloned > 0 and split > 0, "clone_only": cloned > 0 and split == 0,
        "split_only": split > 0 and cloned == 0, "prune_opacity": pruned > 0,
        "screen_prune": pruned > 0, "prune_only": pruned > 0 and cloned + split == 0,
        "capacity_exhaustion": cloned + split == CAP - n_alive + pruned and alive == CAP,
        "full_store": alive == CAP or pruned > 0,
    }[case]
    assert expect, report
    np.testing.assert_array_equal(out_t["alive"], out_j["alive"])
    assert alive == int(out_t["alive"].sum())
    for k, v in out_t.items():
        np.testing.assert_allclose(v, out_j[k], atol=1e-6, rtol=0, err_msg=k)
    for a, b in zip(adc_t, adc_j):
        np.testing.assert_array_equal(a, b)
    carried = convert.opt_state_from_jax(_adam_states(j_state), t_params)
    for moment in ("mu", "nu"):
        for path, _, leaf in t_optim.labelled_leaves(t_state[moment]):
            ref = t_optim.tree_get(carried[moment], path)
            torch.testing.assert_close(leaf, ref, rtol=0, atol=0, msg=str(path))
    touched = (out_t["alive"] & ~t_params["gaussians"]["alive"]) | (
        t_params["gaussians"]["alive"] & ~out_t["alive"])
    if touched.any():
        assert float(t_state["mu"]["gaussians"]["means"][touched].abs().max()) == 0.0
        assert float(t_state["nu"]["gaussians"]["sh_rest"][touched].abs().max()) == 0.0


def test_densify_draws_its_noise_from_the_generator():
    """`densify_and_prune` = `_with_noise` on two normal draws of the
    generator; the same seed gives the same round."""
    rng = np.random.default_rng(3)
    params, adc = _store(rng, 30), _adc(rng)
    cfg = t_config.DensifyConfig(split_scale_threshold_rel=0.0)

    def run(seed):
        p = convert.params_from_jax(params, device="cpu")
        state = t_optim.Optimizer({}).init(p)
        return t_densify.densify_and_prune(
            p["gaussians"], state, convert.adc_from_numpy(*adc, device="cpu"),
            torch.Generator().manual_seed(seed), cfg, 1.0, 100.0)[0]

    a, b, c = run(1), run(1), run(2)
    torch.testing.assert_close(a["means"], b["means"], rtol=0, atol=0)
    assert not torch.equal(a["means"], c["means"])
    eps = torch.randn((2, CAP, 3), generator=torch.Generator().manual_seed(1))
    p = convert.params_from_jax(params, device="cpu")
    by_hand = t_densify.densify_and_prune_with_noise(
        p["gaussians"], t_optim.Optimizer({}).init(p),
        convert.adc_from_numpy(*adc, device="cpu"), eps[0], eps[1], cfg, 1.0, 100.0)[0]
    torch.testing.assert_close(a["means"], by_hand["means"], rtol=0, atol=0)


def test_split_noise_buffer_draws_what_densify_draws():
    """`SplitNoise.draw` (the graphed round's noise: `torch.randn(...,
    out=)` into the static buffer on the CPU; on the card into a pinned
    host buffer, then copied into the static buffer) gives
    the numbers `densify_and_prune` draws, round after round, to the bit,
    and `_with_noise` on them gives its round to the bit."""
    rng = np.random.default_rng(3)
    params, adc = _store(rng, 30), _adc(rng)
    cfg = t_config.DensifyConfig(split_scale_threshold_rel=0.0)
    noise = t_densify.SplitNoise(CAP, "cpu")
    ahead, today = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    for _ in range(2):
        buffer = noise.draw(ahead)
        assert buffer is noise.buffer
        torch.testing.assert_close(
            buffer, torch.randn((2, CAP, 3), generator=torch.Generator().set_state(
                today.get_state()), dtype=torch.float32), rtol=0, atol=0)
        outs = []
        for run in ("today", "buffer"):
            p = convert.params_from_jax(params, device="cpu")
            state = t_optim.Optimizer({}).init(p)
            adc_t = convert.adc_from_numpy(*adc, device="cpu")
            if run == "today":
                outs.append(t_densify.densify_and_prune(p["gaussians"], state, adc_t, today, cfg,
                                                        1.0, 100.0))
            else:
                outs.append(t_densify.densify_and_prune_with_noise(
                    p["gaussians"], state, adc_t, buffer[0], buffer[1], cfg, 1.0, 100.0))
        (a, _, _, rep_a), (b, _, _, rep_b) = outs
        assert [int(x) for x in rep_a] == [int(x) for x in rep_b] and int(rep_a[1]) > 0
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert torch.equal(ahead.get_state(), today.get_state())


def test_reset_opacity_matches_jax(rng):
    params = _store(rng, 30)
    out_j = j_densify.reset_opacity(jax.tree.map(jnp.asarray, params["gaussians"]), 0.02)
    g = convert.params_from_jax(params, device="cpu")["gaussians"]
    out_t = t_densify.reset_opacity(g, 0.02)
    np.testing.assert_allclose(out_t["opacity_logit"], out_j["opacity_logit"], atol=1e-6)
    assert float(torch.sigmoid(out_t["opacity_logit"]).max()) <= 0.02 + 1e-6
    assert out_t["means"] is g["means"] and out_t is not g
    for step, cfg_kw in ((5, dict()), (3001, dict()), (5, dict(screen_prune_from=5))):
        assert t_densify.screen_prune_active(step, t_config.DensifyConfig(**cfg_kw)) == \
            j_densify.screen_prune_active(step, j_config.DensifyConfig(**cfg_kw))


# -- both trainers through the rounds ------------------------------------------


def _cfg(mod):
    cfg = mod.TrainConfig(name="adc-parity")
    cfg.model.max_gaussians = 128
    cfg.model.sh_degree = 1
    cfg.model.num_virtual_views = 2
    cfg.model.crf = mod.CRFConfig(kind="identity")
    cfg.model.rasterize = mod.RasterizeConfig(
        tile_h=8, tile_w=16, tile_capacity=128, max_tiles_per_gaussian=32, chunk=32,
        packed=False, backend="pallas")
    d = cfg.densify
    d.start_iter, d.stop_iter, d.interval = 2, 4, 2
    d.opacity_reset_interval = 3
    d.screen_prune_from = 1
    d.prune_screen_radius = 0.3
    d.grad_threshold = 4e-3
    d.split_scale_threshold_rel = 1e3  # clones only: the trainers' noise differs
    d.sh_degree_interval = 10**6
    cfg.optim.max_steps = 25
    cfg.log_every = 10**9
    cfg.eval_every = 0
    cfg.checkpoint_every = 0
    cfg.data.eval_every = 0
    return cfg


def test_trainers_match_through_density_control_rounds():
    ds_j = j_dataset.make_synthetic_dataset(seed=6, n_gaussians=80, n_frames=4,
                                            n_virtual=2, size=32)
    fields = {}
    for f in dataclasses.fields(t_dataset.Dataset):
        v = getattr(ds_j, f.name)
        fields[f.name] = np.array(v) if isinstance(v, (np.ndarray, jax.Array)) else v
    tj = JaxTrainer(_cfg(j_config), ds_j)
    tt = TorchTrainer(_cfg(t_config), t_dataset.Dataset(**fields), device="cpu")
    np_params = jax.tree_util.tree_map(lambda a: np.array(a), tj.params)
    # anisotropic, rotated splats: the k-NN init is isotropic, which leaves
    # the quaternions a gradient of rounding noise that Adam amplifies
    rng = np.random.default_rng(13)
    g = np_params["gaussians"]
    g["log_scales"] = g["log_scales"] + (rng.normal(size=g["log_scales"].shape)
                                         * 0.3).astype(np.float32)
    g["quats"] = g["quats"] + (rng.normal(size=g["quats"].shape) * 0.3).astype(np.float32)
    tj.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tt.params = convert.params_from_jax(np_params, device="cpu")
    lrs = tt.opt.learning_rates(0)
    seen = []
    for step in range(1, 7):
        out_j, out_t = tj.run_step(), tt.run_step()
        assert set(out_t) == set(out_j), step
        assert abs(out_t["loss"] - out_j["loss"]) <= 1e-3
        if "alive" in out_t:
            report = tuple(out_t[k] for k in ("cloned", "split", "pruned", "alive"))
            assert report == tuple(out_j[k] for k in ("cloned", "split", "pruned", "alive"))
            seen.append((step,) + report)
        np.testing.assert_array_equal(tt.params["gaussians"]["alive"].numpy(),
                                      np.asarray(tj.params["gaussians"]["alive"]))
        if step == 3:  # the opacity reset
            assert float(tt.params["gaussians"]["opacity_logit"].max()) <= np.log(
                0.01 / 0.99) + 1e-6
    # densify rounds at steps 2 and 4, the prune-only round at step 6
    assert [s[0] for s in seen] == [2, 4, 6], seen
    assert seen[0][1] > 0 and seen[0][2] == 0 and seen[0][3] > 0, seen  # clones, prunes
    assert seen[2][1] == 0 and all(s[2] == 0 for s in seen), seen
    alive = 80
    for _, cloned, _, pruned, now in seen:
        alive += cloned - pruned
        assert now == alive, seen
    for path, label, leaf in t_optim.labelled_leaves(tt.params):
        ref = np.asarray(t_optim.tree_get(tj.params, path))
        if label == "frozen":
            np.testing.assert_array_equal(leaf.numpy(), ref)
            continue
        atol = 2e-2 * lrs[label] + 2.4e-7 * float(np.abs(ref).max())
        np.testing.assert_allclose(leaf.numpy(), ref, atol=atol, rtol=0, err_msg=str(path))
