"""The rank side of the port's multi-device tests: functions that
parallel.launch.spawn runs on every rank of a CPU world.  This module
imports torch and the port only (the ranks never load JAX); the test
modules prepare the inputs with the reference, start one world, and hold
what the ranks return against the reference and the one-device port.

Every function takes (rank, device, inputs) and runs its cases on the
meshes of MESHES, all built over the same four ranks."""

from __future__ import annotations

import os
from types import SimpleNamespace

import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch.models import gaussians as gauss_mod
from casualhdrsplat_torch.ops import rasterize as rast
from casualhdrsplat_torch.parallel import render as prender
from casualhdrsplat_torch.parallel import sharding
from casualhdrsplat_torch.parallel.mesh import Mesh
from casualhdrsplat_torch.train import densify as densify_mod
from casualhdrsplat_torch.train import optim as t_optim

MESHES = ((2, 2), (1, 4), (4, 1))
WORLD = 4
# three views where data = 2, so that the view pad runs
N_VIEWS = {2: 3, 1: 4, 4: 4}


def views_for(shape) -> int:
    return N_VIEWS[shape[0]]


def model_cfg(mod, n_views: int, branch: str):
    """The tests' model at the sizes of tests/test_sharding.py: 24x24, 128
    slots, 8x16 tiles, chunk 32, an MLP CRF.  branch "packed" (the
    streaming compositor, the reference's Pallas kernels), "dense" (the
    list form on the kernels' schedule) or "dense_xla" (the plain
    compositor, the reference's XLA one).  The packed branch's stream
    budget is cut to twice the store, so that it overflows."""
    return mod.ModelConfig(
        max_gaussians=128, sh_degree=1, num_virtual_views=n_views,
        crf=mod.CRFConfig(kind="mlp", hidden=8),
        rasterize=mod.RasterizeConfig(
            tile_h=8, tile_w=16, tile_capacity=64, max_tiles_per_gaussian=32, chunk=32,
            packed=branch == "packed", shared_binning=False, stream_factor=2,
            backend="xla" if branch == "dense_xla" else "pallas",
        ),
    )


def _numpy_tree(tree):
    """A copy of `tree` on the host: the trainer writes its tensors in place."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return tree.detach().cpu().numpy().copy() if isinstance(tree, torch.Tensor) else tree


def _grad_tree(params, mesh):
    """The gradients of `params` (their .grad), the store's gathered."""
    grads = {"gaussians": {}}
    for path, label, leaf in t_optim.labelled_leaves(params):
        if label == "frozen":
            continue
        g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
        if path[0] == "gaussians":
            g = sharding.gather_leaf(g, mesh)
        t_optim.tree_set(grads, path, g)
    return _numpy_tree(grads)


def _leaves_requiring_grad(params):
    out = {"crf": {}}
    for path, label, leaf in t_optim.labelled_leaves(params):
        leaf = leaf.detach().clone()
        if label != "frozen":
            leaf.requires_grad_(True)
        t_optim.tree_set(out, path, leaf)
    return out


def frame_case(inputs, mesh, shape, branch):
    """render_frame_sharded of inputs' frame, and the gradients of
    sum(blurred * w) to every parameter leaf."""
    cfg = model_cfg(t_config, views_for(shape), branch)
    scene = convert.scene_from_numpy(SimpleNamespace(**inputs["scene"]), device="cpu")
    full = convert.params_from_jax(inputs["params"], device="cpu")
    params = _leaves_requiring_grad(sharding.shard_params(full, mesh))
    out = prender.render_frame_sharded(params, scene, inputs["frame"], cfg, mesh, sh_degree=1)
    (out.blurred_ldr * torch.as_tensor(inputs["w_blur"])).sum().backward()
    return {
        "blurred": out.blurred_ldr.detach().numpy(), "hdr": out.sharp_hdr.detach().numpy(),
        "alphas": out.alphas.detach().numpy(), "radii": out.aux.radii.numpy(),
        "depths": out.aux.depths.numpy(), "dropped": int(out.aux.num_dropped),
        "grads": _grad_tree(params, mesh),
    }


def _raster_inputs(inputs, shape, branch, device="cpu"):
    cfg = model_cfg(t_config, views_for(shape), branch)
    full = convert.params_from_jax(inputs["params"], device=device)
    vm = torch.as_tensor(inputs["viewmats"][:views_for(shape)])
    return cfg, full, vm


def _raster_loss(hdr, alphas, inputs):
    v = hdr.shape[0]
    return ((hdr * torch.as_tensor(inputs["w_hdr"][:v])).sum()
            + (alphas * torch.as_tensor(inputs["w_alpha"][:v])).sum())


def raster_case(inputs, mesh, shape, branch):
    """rasterize_sharded of the store at inputs' view matrices, and the
    gradients of a weighted sum of its images and alphas to every leaf of
    the store, the view matrices and the screen-gradient probe."""
    cfg, full, vm = _raster_inputs(inputs, shape, branch)
    scene = convert.scene_from_numpy(SimpleNamespace(**inputs["scene"]), device="cpu")
    gp = _leaves_requiring_grad(sharding.shard_params(full, mesh))["gaussians"]
    vm.requires_grad_(True)
    offset = torch.zeros((gp["means"].shape[0], 2), requires_grad=True)
    hdr, alphas, radii, depths, dropped = prender.rasterize_sharded(
        gp, vm, scene.fx, scene.fy, scene.cx, scene.cy, scene.width, scene.height, cfg.rasterize, mesh, 1,
        means2d_offset=offset)
    _raster_loss(hdr, alphas, inputs).backward()
    grads = {k: sharding.gather_leaf(v.grad, mesh).numpy() for k, v in gp.items()
             if v.is_floating_point()}
    grads["viewmats"] = vm.grad.numpy()
    grads["offset"] = sharding.gather_leaf(offset.grad, mesh).numpy()
    return {"hdr": hdr.detach().numpy(), "alphas": alphas.detach().numpy(),
            "radii": radii.numpy(), "depths": depths.numpy(), "dropped": int(dropped),
            "grads": grads}


def one_device_raster(inputs, shape, branch):
    """The yardstick of raster_case: the one-device port's rasterize (the
    per-view branch: shared binning off) on the whole store."""
    cfg, full, vm = _raster_inputs(inputs, shape, branch)
    scene = convert.scene_from_numpy(SimpleNamespace(**inputs["scene"]), device="cpu")
    g = _leaves_requiring_grad(full)["gaussians"]
    vm.requires_grad_(True)
    offset = torch.zeros((g["means"].shape[0], 2), requires_grad=True)
    act = gauss_mod.activate(g)
    from casualhdrsplat_torch.geometry import lie

    colors = gauss_mod.colors_for_view(act, lie.se3_inverse(vm), 1)
    hdr, alphas, aux = rast.rasterize(
        act.means3d, act.quats, act.scales, act.opacities, colors, vm,
        scene.fx, scene.fy, scene.cx, scene.cy, scene.width, scene.height, cfg.rasterize, means2d_offset=offset)
    _raster_loss(hdr, alphas, inputs).backward()
    grads = {k: v.grad.numpy() for k, v in g.items() if v.is_floating_point()}
    grads["viewmats"] = vm.grad.numpy()
    grads["offset"] = offset.grad.numpy()
    # the sharded path reports one counter: the packed branch's clamp cells
    # travel with the budget's drops
    dropped = int(aux.num_dropped) + (int(aux.num_clipped) if cfg.rasterize.packed else 0)
    return {"hdr": hdr.detach().numpy(), "alphas": alphas.detach().numpy(),
            "radii": aux.radii.detach().numpy(), "depths": aux.depths.detach().numpy(),
            "dropped": dropped, "grads": grads}


# bench.build_sharded at the size of tests/test_torch_bench.py
BENCH_TINY = dict(n_gaussians=400, size=64, n_virtual=2)


def bench_case(mesh):
    """One step of bench.build_sharded's workload on this mesh: the loss
    and the gradients of the store, gathered."""
    from casualhdrsplat_torch import bench

    step, (block,), pixels = bench.build_sharded(**BENCH_TINY, mesh=mesh, device="cpu")
    loss, grads = step(block)
    return {"loss": float(loss), "pixels": pixels,
            "grads": {k: sharding.gather_leaf(g, mesh).numpy() for k, g in grads.items()}}


FRAME_BRANCHES = ("packed", "dense_xla")
RASTER_BRANCHES = ("packed", "dense")


def render_world(rank, device, inputs):
    """Every case of tests/test_torch_parallel.py on this rank.  Rank 0
    returns the sharded results (the same on every rank); rank r also
    computes the one-device yardsticks of the cases r, r + 4, ..."""
    torch.manual_seed(0)
    out = {"frame": {}, "raster": {}, "one_device": {}}
    for shape in MESHES:
        mesh = Mesh(*shape)
        for branch in FRAME_BRANCHES:
            out["frame"][shape, branch] = frame_case(inputs, mesh, shape, branch)
        for branch in RASTER_BRANCHES:
            out["raster"][shape, branch] = raster_case(inputs, mesh, shape, branch)
        out["stats", shape] = dict(mesh.stats)
        out["bench", shape] = bench_case(mesh)
    yardsticks = [(n, b) for n in sorted(set(N_VIEWS.values())) for b in RASTER_BRANCHES]
    for n, branch in yardsticks[rank::WORLD]:
        shape = next(s for s in MESHES if views_for(s) == n)
        out["one_device"][n, branch] = one_device_raster(inputs, shape, branch)
    return out



# -- density control on the blocks (tests/test_torch_densify_sharded.py) ------


def _state(case, device="cpu"):
    params = convert.params_from_jax(case["params"], device=device)
    state = convert.opt_state_from_jax(case["groups"], params)
    return params, state, convert.adc_from_numpy(*case["adc"], device=device)


def _gathered(gauss, state, adc, mesh):
    return _numpy_tree({
        "gaussians": sharding.gather_params({"gaussians": gauss}, mesh)["gaussians"],
        "opt": sharding.gather_opt_state(state, mesh),
        "adc": [sharding.gather_leaf(x, mesh) for x in adc],
    })


def densify_case(case, mesh, shape):
    """densify_and_prune_sharded_with_noise of the case's store on this
    rank's block, with the reference's noise for the block."""
    params, state, adc = _state(case)
    cap = params["gaussians"]["alive"].shape[0]
    g = mesh.axis_index("gauss")
    eps = torch.as_tensor(case["eps"][shape][g])
    out, state, adc, report = densify_mod.densify_and_prune_sharded_with_noise(
        sharding.shard_params(params, mesh)["gaussians"], sharding.shard_opt_state(state, mesh),
        sharding.shard_tree(adc, cap, mesh), eps[0], eps[1],
        t_config.DensifyConfig(**case["overrides"]), case["extent"], case["diag"], mesh,
        screen_prune=case["screen_prune"], prune_only=case["prune_only"])
    res = _gathered(out, state, adc, mesh)
    res["report"] = [int(x) for x in report]
    return res


def generator_round(case, mesh):
    """A round drawing its noise from the block's generator, seeded by
    (seed, block) as the trainer seeds it: this rank's block of the result."""
    params, state, adc = _state(case)
    cap = params["gaussians"]["alive"].shape[0]
    g = mesh.axis_index("gauss")
    gen = torch.Generator().manual_seed(1000 + g)
    out, _, _, _ = densify_mod.densify_and_prune_sharded(
        sharding.shard_params(params, mesh)["gaussians"], sharding.shard_opt_state(state, mesh),
        sharding.shard_tree(adc, cap, mesh), gen,
        t_config.DensifyConfig(split_scale_threshold_rel=0.0), 1.0, 100.0, mesh)
    return out["means"].numpy()


def rebalance_case(case, mesh):
    """rebalance_store of the case's store over this mesh's blocks."""
    params, state, adc = _state(case)
    cap = params["gaussians"]["alive"].shape[0]
    out, state, adc = densify_mod.rebalance_store(
        sharding.shard_params(params, mesh)["gaussians"], sharding.shard_opt_state(state, mesh),
        sharding.shard_tree(adc, cap, mesh), mesh.shape["gauss"], mesh=mesh)
    return _gathered(out, state, adc, mesh)


def densify_world(rank, device, inputs):
    """Every case of tests/test_torch_densify_sharded.py on this rank: rank
    0 returns the gathered results; every rank its block of the generator
    rounds."""
    out = {"densify": {}, "rebalance": {}, "generator": {}}
    for shape in MESHES:
        mesh = Mesh(*shape)
        for name, case in inputs["densify"].items():
            out["densify"][shape, name] = densify_case(case, mesh, shape)
        out["rebalance"][shape] = rebalance_case(inputs["rebalance"], mesh)
        out["generator"][shape] = generator_round(inputs["rebalance"], mesh)
    return out


# -- the trainer's mesh path (tests/test_torch_trainer_sharded.py) -------------


def trainer_cfg(data: int, gauss: int):
    """A packed trainer with density control through two rounds (at steps 2
    and 4) and an opacity reset (step 3), splits off: the trainers' split
    noise differs.  256 slots for 80 points, so that every block of the
    (2, 2) mesh has room for the round's clones."""
    cfg = t_config.TrainConfig(name="mesh-parity")
    cfg.model.max_gaussians = 256
    cfg.model.sh_degree = 1
    cfg.model.num_virtual_views = 2
    cfg.model.crf = t_config.CRFConfig(kind="mlp", hidden=8)
    cfg.model.rasterize = t_config.RasterizeConfig(
        tile_h=8, tile_w=16, tile_capacity=64, max_tiles_per_gaussian=32, chunk=32,
        shared_binning=False)
    d = cfg.densify
    d.start_iter, d.stop_iter, d.interval = 2, 4, 2
    d.opacity_reset_interval = 3
    d.screen_prune_from = 1
    d.prune_screen_radius = 0.3
    d.grad_threshold = 4e-3
    d.split_scale_threshold_rel = 1e3
    d.sh_degree_interval = 10**6
    d.rebalance_threshold = 0.0  # off for the parity steps; switched on after
    cfg.parallel = t_config.ParallelConfig(data=data, gauss=gauss)
    cfg.optim.max_steps = 25
    cfg.log_every = 10**9
    cfg.eval_every = 0
    cfg.checkpoint_every = 0
    cfg.data.eval_every = 0
    return cfg


def make_trainer(inputs, mesh=None, device="cpu"):
    """A trainer on inputs' dataset whose parameters are inputs' (cut to
    the rank's block on a mesh)."""
    from casualhdrsplat_torch.data.dataset import Dataset
    from casualhdrsplat_torch.train.trainer import Trainer

    shape = (1, 1) if mesh is None else (mesh.shape["data"], mesh.shape["gauss"])
    t = Trainer(trainer_cfg(*shape), Dataset(**inputs["dataset"]), device=device, mesh=mesh)
    params = convert.params_from_jax(inputs["params"], device=device)
    t.params = params if mesh is None else sharding.shard_params(params, mesh)
    return t


def _full_state(t):
    """The trainer's params, moments and statistics, the store gathered."""
    if t.mesh is None:
        return _numpy_tree({"params": t.params, "opt": t.opt_state, "adc": list(t.adc)})
    return _numpy_tree({"params": sharding.gather_params(t.params, t.mesh),
                        "opt": sharding.gather_opt_state(t.opt_state, t.mesh),
                        "adc": [sharding.gather_leaf(x, t.mesh) for x in t.adc]})


def trainer_world(rank, device, inputs):
    """A (2, 2) trainer through 4 steps, a rebalance and a step after it;
    its checkpoint loaded into a one-device trainer (rank 0) and that one's
    checkpoint back into a second (2, 2) trainer."""
    import torch.distributed as dist

    mesh = Mesh(2, 2)
    t = make_trainer(inputs, mesh)
    out = {"steps": [t.run_step() for _ in range(4)]}
    out["counts_before"] = t._shard_counts()
    t.cfg.densify.rebalance_threshold = 0.25
    out["rebalanced"] = t._maybe_rebalance()
    out["counts_after"] = t._shard_counts()
    out["again"] = t._maybe_rebalance()
    path_a = t.save(inputs["dir_a"])
    out["saved"] = _full_state(t)
    out["next_step"] = t.run_step()
    path_b = os.path.join(inputs["dir_b"], os.path.basename(path_a))
    if rank == 0:  # a one-device trainer takes the sharded checkpoint, and back
        u = make_trainer(inputs)
        u.load(path_a)
        out["one_device_loaded"] = _full_state(u)
        u.save(inputs["dir_b"])
        out["one_device_next_step"] = u.run_step()
    dist.barrier()
    t2 = make_trainer(inputs, mesh)
    t2.load(path_b)
    out["reloaded"] = _full_state(t2)
    out["reloaded_next_step"] = t2.run_step()
    out["stats"] = dict(mesh.stats)
    return out
