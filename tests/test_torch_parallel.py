"""Port parity: parallel/ (the mesh, the collectives and the sharded
rasterizer) against the JAX package's shard_map path and against the
one-device port.

One world of four gloo ranks on CPU processes (parallel.launch.spawn) runs
every case on the meshes (2, 2), (1, 4) and (4, 1), built over the same
four ranks (tests/torch_parallel_cases.py); the reference runs under
jax.jit on four of the eight virtual CPU devices, the packed branch through
its Pallas kernels in interpret mode, the dense one through its XLA
compositor, as tests/test_sharding.py runs it.  Inputs: the port's
synthetic fixture (24x24, 4 frames, 100 points), the reference's
init_params on its scene with the scales, rotations and SH perturbed, all
carried across as numpy; three views where data = 2, so that the view pad
runs, four otherwise.

Tolerances.
- render_frame_sharded against the reference's: images atol 1e-5 (as
  tests/test_torch_image_formation.py), radii and the dropped count equal,
  depths atol 1e-5; the gradients of sum(blurred * w) to every parameter
  leaf (the store, knots, exposures, CRF) atol 1e-4 * scale + rtol 1e-3, as
  tests/test_torch_train_step.py (sums over pixels and slots run in
  another order in each package).
- rasterize_sharded against the one-device port's per-view branch: every
  output equal, bit for bit (each tile is the same computation on the same
  rows); the gradients of every store leaf, the view matrices and the
  screen-gradient probe rtol 1e-5 + 1e-6 * scale: the same per-slot terms,
  summed by the collectives' all-reduces in another order.
"""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as j_bench
import torch_parallel_cases as cases
from casualhdrsplat_torch import bench as t_bench
from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.ops import rasterize_packed as t_rp
from casualhdrsplat_torch.parallel import distributed as t_distributed
from casualhdrsplat_torch.parallel import launch
from casualhdrsplat_torch.parallel import mesh as t_mesh
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.data import dataset as j_dataset
from casualhdrsplat_tpu.geometry import spline as j_spline
from casualhdrsplat_tpu.models import image_formation as j_imf
from casualhdrsplat_tpu.parallel import mesh as j_mesh
from casualhdrsplat_tpu.parallel import render as j_render
from casualhdrsplat_tpu.parallel import sharding as j_sharding
from torch_threads import one_torch_thread  # noqa: F401

SIZE = 24
SCENE_FIELDS = ("base_knots", "knot_t0", "knot_dt", "timestamps", "fx", "fy", "cx", "cy",
                "width", "height")


def _inputs():
    """(inputs for the ranks, the reference's scene and parameters)."""
    ds_t = t_dataset.make_synthetic_dataset(seed=5, device="cpu", n_gaussians=100,
                                            n_frames=4, n_virtual=2, size=SIZE)
    ds = j_dataset.Dataset(**{f.name: getattr(ds_t, f.name)
                              for f in dataclasses.fields(t_dataset.Dataset)})
    cfg = cases.model_cfg(j_config, 4, "packed")
    scene = j_imf.build_scene(ds, cfg)
    params = jax.tree.map(np.array, j_imf.init_params(scene, ds.points_xyz, ds.points_rgb, cfg))
    rng = np.random.default_rng(13)
    g = params["gaussians"]
    for k, s in (("log_scales", 0.3), ("quats", 0.3), ("sh_rest", 0.1)):
        g[k] = (g[k] + rng.normal(size=g[k].shape) * s).astype(np.float32)
    frame = 1
    viewmats = np.asarray(j_imf.poses_at(
        params, scene, j_spline.sample_virtual_times(
            scene.timestamps[frame], j_imf.exposure_of(params, frame), 4), cfg))
    inputs = {
        "params": params, "frame": frame, "viewmats": viewmats,
        "scene": {f: np.asarray(getattr(scene, f)) for f in SCENE_FIELDS},
        "w_blur": rng.uniform(size=(SIZE, SIZE, 3)).astype(np.float32),
        "w_hdr": rng.uniform(size=(4, SIZE, SIZE, 3)).astype(np.float32),
        "w_alpha": rng.uniform(size=(4, SIZE, SIZE)).astype(np.float32),
    }
    return inputs, scene, params


def _jax_frame(inputs, scene, params, shape, branch):
    """The reference's render_frame_sharded and the gradients of
    sum(blurred * w), as numpy."""
    cfg = cases.model_cfg(j_config, cases.views_for(shape), branch)
    mesh = j_mesh.make_mesh(j_config.ParallelConfig(*shape), devices=jax.devices()[:4])
    p = j_sharding.shard_params(jax.tree.map(jnp.asarray, params), mesh)
    w = jnp.asarray(inputs["w_blur"])
    frame = jnp.asarray(inputs["frame"])

    def loss(p):
        out = j_render.render_frame_sharded(p, scene, frame, cfg, mesh, sh_degree=1)
        return jnp.sum(out.blurred_ldr * w), (
            out.blurred_ldr, out.sharp_hdr, out.alphas, out.aux.radii, out.aux.depths,
            out.aux.num_dropped)

    (_, outs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True, allow_int=True))(p)
    keys = ("blurred", "hdr", "alphas", "radii", "depths", "dropped")
    res = dict(zip(keys, jax.tree.map(np.asarray, outs)))
    res["grads"] = jax.tree.map(np.asarray, grads)
    return res


@pytest.fixture(scope="module")
def world():
    """The ranks' results and the reference's, computed side by side: the
    world runs in its own processes while this one runs the reference."""
    inputs, scene, params = _inputs()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        ranks = pool.submit(launch.spawn, cases.render_world, 4, "gloo", "cpu",
                            args=(inputs,), timeout=600)
        # the reference's compiles run in threads of their own: XLA
        # compiles without the interpreter lock
        jobs = {(shape, branch): pool.submit(_jax_frame, inputs, scene, params, shape, branch)
                for shape in cases.MESHES for branch in cases.FRAME_BRANCHES}
        # the reference's mesh here is its fallback over all 8 devices; the
        # value does not depend on the mesh (tests/test_sharding.py)
        step, args, pixels = j_bench.build_sharded(**cases.BENCH_TINY)
        loss, grads = step(*args)
        ref = {k: job.result() for k, job in jobs.items()}
        ref["bench"] = {"loss": float(loss), "pixels": pixels,
                        "grads": jax.tree.map(np.asarray, grads)}
        results = ranks.result()
    one_device = {}
    for r in results:
        one_device.update(r["one_device"])
    return results[0], one_device, ref


CASES = [(s, b) for s in cases.MESHES for b in cases.FRAME_BRANCHES]
RASTER_CASES = [(s, b) for s in cases.MESHES for b in cases.RASTER_BRANCHES]


def _ids(case):
    return f"{case[0][0]}x{case[0][1]}-{case[1]}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_render_frame_sharded_matches_jax(world, case):
    got, ref = world[0]["frame"][case], world[2][case]
    for k in ("blurred", "hdr", "alphas"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["radii"], ref["radii"])
    np.testing.assert_allclose(got["depths"], ref["depths"], atol=1e-5, rtol=0)
    assert got["dropped"] == int(ref["dropped"])
    n_leaves = 0
    for path, label, leaf in cases.t_optim.labelled_leaves(got["grads"]):
        want = np.asarray(cases.t_optim.tree_get(ref["grads"], path))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(leaf, want, atol=1e-4 * scale, rtol=1e-3, err_msg=str(path))
        n_leaves += 1
    assert n_leaves == 6 + 2 + 5  # the store, knots and exposures, the MLP CRF


@pytest.mark.parametrize("case", RASTER_CASES, ids=_ids)
def test_rasterize_sharded_equals_one_device(world, case):
    shape, branch = case
    got = world[0]["raster"][case]
    ref = world[1][cases.views_for(shape), branch]
    for k in ("hdr", "alphas", "radii", "depths"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["dropped"] == ref["dropped"]
    assert set(got["grads"]) == set(ref["grads"]) == {
        "means", "quats", "log_scales", "opacity_logit", "sh_dc", "sh_rest", "viewmats",
        "offset"}
    for k, want in ref["grads"].items():
        scale = float(np.abs(want).max())
        assert scale > 0, k
        np.testing.assert_allclose(got["grads"][k], want, atol=1e-6 * scale, rtol=1e-5,
                                   err_msg=k)


def test_the_cases_reach_drops_and_pads(world):
    """The fixture reaches what it should: stream-budget and capacity drops
    on both branches, the view pad at data = 2, padded tiles at gauss = 4
    (the 2x3 tiles of 8x16 on 24x24 do not split into 4)."""
    for branch in cases.RASTER_BRANCHES:
        assert world[0]["raster"][(2, 2), branch]["dropped"] > 0, branch
    assert cases.views_for((2, 2)) % 2 == 1
    cfg = cases.model_cfg(t_config, 3, "packed").rasterize
    assert (-(-SIZE // cfg.tile_w) * -(-SIZE // cfg.tile_h)) % 4


def test_collectives_ran_with_their_rules(world):
    """Each collective of the step ran on every mesh, its gradient rule
    among them (mesh.stats: calls, bytes, host seconds)."""
    for shape in cases.MESHES:
        stats = world[0]["stats", shape]
        for name in ("payload", "payload.grad", "aux", "images", "viewmats.grad",
                     "store.grad", "offset.grad", "bin_starts", "bin_ids", "dropped"):
            assert stats[name][0] > 0 and stats[name][1] > 0, (shape, name)


@pytest.mark.parametrize("shape", cases.MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bench_build_sharded_matches_jax(world, shape):
    """bench.build_sharded's step against the reference's, at the size of
    tests/test_torch_bench.py and with its tolerances: the loss within 1e-5
    relative, each store gradient within 1e-4 of its largest value + rtol
    1e-3.  The mesh shares the per-card pixel count, not the total."""
    got, ref = world[0]["bench", shape], world[2]["bench"]
    assert got["pixels"] == ref["pixels"]
    assert got["loss"] == pytest.approx(ref["loss"], rel=1e-5)
    assert set(got["grads"]) == {"means", "quats", "log_scales", "opacity_logit", "sh_dc",
                                 "sh_rest"}
    for k, g in got["grads"].items():
        want = np.asarray(ref["grads"][k])
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(g, want, atol=1e-4 * scale, rtol=1e-3, err_msg=k)


def test_bench_sharded_needs_a_world_above_one(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node=4"):
        t_bench.main(["--device", "cpu", "--sharded", "2,2"])


def test_cli_needs_a_launched_world_for_a_mesh(monkeypatch):
    from casualhdrsplat_torch import cli

    for var in ("WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit, match="torchrun --nproc_per_node=4 -m "
                                         "casualhdrsplat_torch.cli train"):
        cli.main(["train", "--device", "cpu", "parallel.data=2", "parallel.gauss=2"])


def test_table_as_lists_is_the_table():
    """A gathered table passed as lists on unique ids (how composite_tiles
    reaches the card's kernels, which read lists only) composites and
    differentiates as the table itself, on a slice with a padded stride."""
    from casualhdrsplat_torch.ops import composite

    rng = np.random.default_rng(3)
    tt, cap = 5, 32
    table = np.zeros((tt, cap, 16), np.float32)
    table[..., 0] = rng.uniform(0, 48, (tt, cap))
    table[..., 1] = rng.uniform(0, 16, (tt, cap))
    table[..., 2] = table[..., 4] = 0.2
    table[..., 5] = rng.uniform(0.05, 0.9, (tt, cap))
    table[..., 6:9] = rng.uniform(0, 1, (tt, cap, 3))
    table[..., 9] = 1.0
    counts = torch.tensor([0, 7, 32, 20, 3], dtype=torch.int32)
    table[np.arange(cap)[None, :] >= counts.numpy()[:, None]] = 0.0
    gathered = torch.as_tensor(table).requires_grad_(True)
    statics = composite.CompositeStatics(num_views=2, ntx=3, nty=1, tile_h=8, tile_w=16,
                                         chunk=16, alpha_clip=0.99, alpha_threshold=1 / 255,
                                         tiles_per_view=4)
    ti = torch.tensor([1, 2, 4, 5, 6], dtype=torch.int32)
    rows, ids, ti1, one_view = composite.table_as_lists(gathered, ti, statics)
    assert one_view.num_views == 1 and (ti1 < 4).all() and (ids.flatten() ==
                                                           torch.arange(tt * cap)).all()
    out = composite.composite_tile_lists(rows, ids, one_view, tile_indices=ti1, counts=counts)
    want = composite.composite_tiles(gathered, statics, tile_indices=ti, counts=counts)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    g4 = torch.rand(out.shape)
    (d,) = torch.autograd.grad(out, gathered, g4)
    (d_want,) = torch.autograd.grad(want, gathered, g4)
    torch.testing.assert_close(d, d_want, rtol=1e-6, atol=1e-7)


def test_clip_cotangent_rows():
    """Identity forward; backward zeroes the cotangent outside [lo, hi)."""
    x = torch.arange(6 * 16, dtype=torch.float32).reshape(6, 16).requires_grad_(True)
    lo, hi = torch.tensor(2), torch.tensor(5)
    y = t_rp.clip_cotangent_rows(x, lo, hi)
    torch.testing.assert_close(y, x, rtol=0, atol=0)
    g = torch.rand(6, 16)
    (y * g).sum().backward()
    want = g.clone()
    want[:2] = 0.0
    want[5:] = 0.0
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)
    x.grad = None
    (t_rp.clip_cotangent_rows(x, 0, 0) * g).sum().backward()
    assert float(x.grad.abs().max()) == 0.0


@pytest.mark.parametrize("cfg,world_size", [((2, 2), 4), ((4, 2), 8), ((3, 5), 4),
                                             ((3, 2), 4), ((1, 1), 4), ((2, 4), 8)])
def test_mesh_shape_follows_the_reference(cfg, world_size):
    got = t_mesh.mesh_shape(t_config.ParallelConfig(*cfg), world_size)
    ref = j_mesh.make_mesh(j_config.ParallelConfig(*cfg), devices=jax.devices()[:world_size])
    assert got == (ref.shape["data"], ref.shape["gauss"])


def test_parallel_config_from_the_reference():
    d = j_config.to_dict(j_config.PRESETS["ladder5"]())
    cfg = t_config.from_dict(d)
    assert cfg.parallel == t_config.ParallelConfig(data=4, gauss=2)
    assert t_config.to_dict(cfg) == d
    t_config.with_overrides(cfg, ["parallel.data=1", "parallel.gauss=4"])
    assert (cfg.parallel.data, cfg.parallel.gauss) == (1, 4)


def test_initialize_needs_a_launched_world(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(var, raising=False)
    assert t_distributed.initialize() is None
    assert t_distributed.backend_for("cpu") == "gloo"
    assert t_distributed.backend_for(torch.device("cuda")) == "nccl"
    assert t_distributed.backend_for("cuda", "gloo") == "gloo"
    with pytest.raises(RuntimeError, match="torchrun"):
        t_mesh.make_mesh(t_config.ParallelConfig(2, 1))
    assert not os.environ.get("WORLD_SIZE")
