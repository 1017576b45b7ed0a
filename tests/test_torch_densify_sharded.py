"""Port parity: density control on a `gauss`-sharded store
(train/densify.py: densify_and_prune_sharded, shard_alive_counts,
rebalance_store) against the JAX package.

One world of four gloo ranks on CPU processes runs every case on the meshes
(2, 2), (1, 4) and (4, 1) (tests/torch_parallel_cases.py::densify_world);
the reference runs its shard_map round under jax.jit on four of the eight
virtual CPU devices, with the same meshes.

The split noise is the reference's own: block g of a round draws
jax.random.normal(fold_in(key, g), (2, block, 3)) inside the reference's
shard_map, and the test feeds the same numbers to the port's
`densify_and_prune_sharded_with_noise`, as tests/test_torch_densify.py does
for one device.  With that every leaf agrees to atol 1e-6 (the rotation's
float32 sums), `alive`, the report and the zeroed moments exactly.
rebalance_store is a pure permutation: equal bit for bit, moments and
statistics included.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_cases as cases
from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch.parallel import launch
from casualhdrsplat_torch.train import densify as t_densify
from casualhdrsplat_torch.train import optim as t_optim
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.parallel import mesh as j_mesh
from casualhdrsplat_tpu.train import densify as j_densify
from casualhdrsplat_tpu.train import optim as j_optim
from torch_threads import one_torch_thread  # noqa: F401

CAP = 64


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


def _store(rng, alive):
    """A numpy parameter tree whose store has every kind of Gaussian: small
    and large, faint and opaque, dead slots in between."""
    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)

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


def _with_moments(rng, params):
    """(the reference's optimizer state after one Adam update of random
    gradients, so that the moments are not zero; its numpy groups)."""
    j_params = jax.tree.map(jnp.asarray, params)
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
    grads["gaussians"]["alive"] = np.zeros(CAP, bool)
    opt = j_optim.make_optimizer(j_config.OptimConfig())
    _, state = opt.update(jax.tree.map(jnp.asarray, grads), opt.init(j_params), j_params)
    return state, _adam_states(state)


def _structured(kind):
    """The reference's two sharded cases (tests/test_densify.py): alive in
    the first half of every quarter, four requesters in the third quarter
    (shard-local allocation); or the first quarter full with its own four
    requesters (a full block defers them where blocks are quarters)."""
    alive = np.zeros(CAP, bool)
    grads = np.zeros(CAP, np.float32)
    q = CAP // 4
    if kind == "shard_local":
        for b in range(4):
            alive[b * q:b * q + q // 2] = True
        grads[2 * q:2 * q + 4] = 1.0
    else:
        alive[:q] = True
        grads[:4] = 1.0
    return alive, (grads, np.ones(CAP, np.int32), np.ones(CAP, np.float32))


DENSIFY_CASES = {
    # name: (alive, adc or None for random, DensifyConfig overrides,
    #        screen_prune, prune_only)
    "shard_local": (*_structured("shard_local"), dict(), False, False),
    "shard_full": (*_structured("shard_full"), dict(), False, False),
    "clone_and_split": (30, None, dict(), False, False),
    "prune_only": (30, None, dict(prune_screen_radius=0.1), True, True),
    "capacity_exhaustion": (56, None, dict(grad_threshold=1e-5, prune_opacity=0.0), False,
                            False),
}


def _densify_inputs():
    """(the ranks' inputs by case, the reference's optimizer states)."""
    inputs, states = {}, {}
    for i, (name, (alive, adc, overrides, screen, prune_only)) in enumerate(
            DENSIFY_CASES.items()):
        rng = np.random.default_rng(20 + i)
        if isinstance(alive, int):
            n_alive, alive = alive, np.zeros(CAP, bool)
            alive[rng.permutation(CAP)[:n_alive]] = True
        params = _store(rng, alive)
        if adc is not None:  # the structured cases: opaque, so none is pruned
            params["gaussians"]["opacity_logit"][:] = 0.0
        else:
            adc = (rng.uniform(0, 2e-3, size=CAP).astype(np.float32),
                   rng.integers(0, 4, size=CAP).astype(np.int32),
                   rng.uniform(0, 30, size=CAP).astype(np.float32))
        states[name], groups = _with_moments(rng, params)
        key = jax.random.PRNGKey(7 + i)
        # block g's noise: the reference folds g into the round's key
        eps = {shape: np.stack([
            np.asarray(jax.random.normal(jax.random.fold_in(key, g), (2, CAP // shape[1], 3)))
            for g in range(shape[1])]) for shape in cases.MESHES}
        inputs[name] = {"params": params, "groups": groups, "adc": adc,
                        "overrides": overrides, "extent": 1.7, "diag": 100.0,
                        "screen_prune": screen, "prune_only": prune_only, "eps": eps,
                        "seed": 7 + i}
    return inputs, states


def _densify_reference(inputs, states, pool):
    """The reference's sharded round of every case on every mesh, each
    compiled in a thread of `pool` (XLA compiles without the interpreter
    lock)."""

    def one(name, case, shape):
        cfg = j_config.DensifyConfig(**case["overrides"])
        mesh = j_mesh.make_mesh(j_config.ParallelConfig(*shape), devices=jax.devices()[:4])
        run = jax.jit(lambda g, s, a, k: j_densify.densify_and_prune_sharded(
            g, s, a, k, cfg, case["extent"], case["diag"], mesh,
            screen_prune=case["screen_prune"], prune_only=case["prune_only"]))
        out, state, adc_out, report = run(
            jax.tree.map(jnp.asarray, case["params"]["gaussians"]), states[name],
            j_densify.AdcState(*map(jnp.asarray, case["adc"])),
            jax.random.PRNGKey(case["seed"]))
        return {"gaussians": jax.tree.map(np.asarray, out), "groups": _adam_states(state),
                "adc": [np.asarray(x) for x in adc_out], "report": [int(x) for x in report]}

    jobs = {(shape, name): pool.submit(one, name, case, shape)
            for name, case in inputs.items() for shape in cases.MESHES}
    return {k: job.result() for k, job in jobs.items()}


def _rebalance_inputs():
    """A store whose 20 alive Gaussians fill the first slots (its blocks
    as uneven as they get), distinctive moments and statistics."""
    rng = np.random.default_rng(7)
    alive = np.zeros(CAP, bool)
    alive[:20] = True
    params = _store(rng, alive)
    j_state, groups = _with_moments(rng, params)
    adc = (np.arange(CAP, dtype=np.float32), np.arange(CAP, dtype=np.int32),
           np.arange(CAP, dtype=np.float32) * 2.0)
    return {"params": params, "groups": groups, "adc": adc}, j_state


@pytest.fixture(scope="module")
def world():
    reb, reb_state = _rebalance_inputs()
    d_inputs, states = _densify_inputs()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        # the ranks run while this process runs the reference's rounds
        ranks = pool.submit(launch.spawn, cases.densify_world, 4, "gloo", "cpu",
                            args=({"densify": d_inputs, "rebalance": reb},), timeout=600)
        d_ref = _densify_reference(d_inputs, states, pool)
        results = ranks.result()
    return results, d_inputs, d_ref, reb, reb_state


def _port_moments(groups, params_np):
    return cases._numpy_tree(convert.opt_state_from_jax(
        groups, convert.params_from_jax(params_np, device="cpu")))


@pytest.mark.parametrize("shape", cases.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(DENSIFY_CASES))
def test_densify_and_prune_sharded_matches_jax(world, name, shape):
    results, inputs, ref = world[:3]
    got, want = results[0]["densify"][shape, name], ref[shape, name]
    assert got["report"] == want["report"], (got["report"], want["report"])
    np.testing.assert_array_equal(got["gaussians"]["alive"], want["gaussians"]["alive"])
    for k, v in got["gaussians"].items():
        np.testing.assert_allclose(v, want["gaussians"][k], atol=1e-6, rtol=0, err_msg=k)
    for a, b in zip(got["adc"], want["adc"]):
        np.testing.assert_array_equal(a, b)
    carried = _port_moments(want["groups"], inputs[name]["params"])
    for moment in ("mu", "nu"):
        for path, _, leaf in t_optim.labelled_leaves(got["opt"][moment]):
            np.testing.assert_array_equal(leaf, t_optim.tree_get(carried[moment], path),
                                          err_msg=str(path))
    cloned, split, pruned, alive = got["report"]
    before = inputs[name]["params"]["gaussians"]["alive"]
    new = np.flatnonzero(got["gaussians"]["alive"] & ~before)
    block = CAP // shape[1]
    if name == "shard_local":  # every new slot in the requesters' block
        assert cloned + split == 4 and len(new) == 4
        assert (new // block == (CAP // 2) // block).all(), new
    if name == "shard_full" and shape[1] == 4:  # deferred, not stolen
        assert cloned + split == 0 and alive == CAP // 4
    assert alive == int(got["gaussians"]["alive"].sum())


def test_rounds_reach_their_cases(world):
    """clone_and_split clones and splits, prune_only prunes and grows
    nothing, capacity_exhaustion fills some block."""
    results = world[0]
    for shape in cases.MESHES:
        c, s, _, _ = results[0]["densify"][shape, "clone_and_split"]["report"]
        assert c > 0 and s > 0, shape
        c, s, p, _ = results[0]["densify"][shape, "prune_only"]["report"]
        assert p > 0 and c + s == 0, shape
    alive = results[0]["densify"][(1, 4), "capacity_exhaustion"]["gaussians"]["alive"]
    assert alive.reshape(4, -1).all(axis=1).any()


def test_block_generators_keep_the_data_replicas_together(world):
    """A round drawing from the blocks' generators: the data replicas of a
    block (same g) draw the same noise, other blocks other noise."""
    results = world[0]
    for shape in cases.MESHES:
        blocks = [r["generator"][shape] for r in results]
        for rank, b in enumerate(blocks):
            d, g = divmod(rank, shape[1])
            np.testing.assert_array_equal(b, blocks[g])  # rank g: data row 0
    a, b = results[0]["generator"][(1, 4)], results[1]["generator"][(1, 4)]
    assert a.shape == b.shape and not np.array_equal(a, b)


@pytest.mark.parametrize("shape", cases.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rebalance_store_equals_the_reference_bit_for_bit(world, shape):
    """On the mesh's blocks and, without a mesh, on the full store: the
    reference's permutation, moments and statistics included."""
    results, reb, j_state = world[0], world[3], world[4]
    n_shards = shape[1]
    g = jax.tree.map(jnp.asarray, reb["params"]["gaussians"])
    out_j, state_j, adc_j = j_densify.rebalance_store(
        g, j_state, j_densify.AdcState(*map(jnp.asarray, reb["adc"])), n_shards)
    want = {"gaussians": jax.tree.map(np.asarray, out_j),
            "opt": _port_moments(_adam_states(state_j), reb["params"]),
            "adc": [np.asarray(x) for x in adc_j]}
    params, state, adc = cases._state(reb)
    plain = t_densify.rebalance_store(params["gaussians"], state, adc, n_shards)
    plain = cases._numpy_tree({"gaussians": plain[0], "opt": plain[1], "adc": list(plain[2])})
    for got in (results[0]["rebalance"][shape], plain):
        for k, v in got["gaussians"].items():
            np.testing.assert_array_equal(v, want["gaussians"][k], err_msg=k)
        for a, b in zip(got["adc"], want["adc"]):
            np.testing.assert_array_equal(a, b)
        for moment in ("mu", "nu"):
            for path, _, leaf in t_optim.labelled_leaves(got["opt"][moment]):
                np.testing.assert_array_equal(
                    leaf, t_optim.tree_get(want["opt"][moment], path), err_msg=str(path))
    counts = t_densify.shard_alive_counts(torch.as_tensor(np.array(want["gaussians"]["alive"])),
                                          n_shards).numpy()
    np.testing.assert_array_equal(counts, np.asarray(j_densify.shard_alive_counts(
        jnp.asarray(want["gaussians"]["alive"]), n_shards)))
    assert counts.sum() == 20 and counts.max() - counts.min() <= 1, counts


def test_rebalance_order_is_a_permutation():
    alive = torch.zeros(CAP, dtype=torch.bool)
    alive[:20] = True
    for n_shards in (1, 2, 4, 8):
        src = t_densify.rebalance_order(alive, n_shards)
        assert sorted(src.tolist()) == list(range(CAP))
    with pytest.raises(ValueError, match="not divisible"):
        t_densify.rebalance_order(alive, 3)
    assert t_config.DensifyConfig().rebalance_threshold == \
        j_config.DensifyConfig().rebalance_threshold
