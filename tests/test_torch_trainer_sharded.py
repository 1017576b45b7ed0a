"""The trainer's mesh path (train/trainer.py with a (data, gauss) mesh)
against the one-device port trainer, and checkpoints across the two.

One world of four gloo ranks on CPU processes runs a (2, 2) trainer
(tests/torch_parallel_cases.py::trainer_world) while this process runs the
one-device trainer from the same state: the port's synthetic fixture
(32x32, 4 frames, 80 points, 256 slots), the parameters with perturbed
scales and rotations, the packed path, density control through two rounds
and an opacity reset, splits off (the two trainers' split noise differs).

Tolerances.
- The first step: loss and PSNR equal (the sharded forward is the
  one-device one, bit for bit: tests/test_torch_parallel.py).
- Steps 2-4: loss atol 1e-5, PSNR atol 1e-3 dB: the gradients' all-reduces
  sum in another order, and Adam turns the last-bit differences into
  parameter differences of ~1e-7 lr; the density-control reports equal.
- Checkpoints: the state written by one kind of trainer and read by the
  other equal bit for bit; the step after it: loss atol 1e-5.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

import torch_parallel_cases as cases
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.parallel import launch
from casualhdrsplat_torch.train import optim as t_optim
from casualhdrsplat_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401

REPORT = ("cloned", "split", "pruned", "alive")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    ds = t_dataset.make_synthetic_dataset(seed=6, device="cpu", n_gaussians=80, n_frames=4,
                                          n_virtual=2, size=32)
    fields = {f.name: getattr(ds, f.name) for f in dataclasses.fields(t_dataset.Dataset)}
    init = Trainer(cases.trainer_cfg(1, 1), t_dataset.Dataset(**fields), device="cpu")
    params = cases._numpy_tree(init.params)
    # anisotropic, rotated splats: the k-NN init is isotropic, which leaves
    # the quaternions a gradient of rounding noise that Adam amplifies
    rng = np.random.default_rng(13)
    g = params["gaussians"]
    for k in ("log_scales", "quats"):
        g[k] = (g[k] + rng.normal(size=g[k].shape) * 0.3).astype(np.float32)
    inputs = {"dataset": fields, "params": params, "dir_a": str(tmp / "a"),
              "dir_b": str(tmp / "b")}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, cases.trainer_world, 4, "gloo", "cpu",
                            args=(inputs,), timeout=600)
        one = cases.make_trainer(inputs)
        steps = [one.run_step() for _ in range(4)]
        results = ranks.result()
    return results, steps


def test_mesh_trainer_matches_the_one_device_trainer(world):
    results, one = world
    mesh = results[0]["steps"]
    for r in results[1:]:  # every rank read the same scalars
        assert r["steps"] == mesh
    assert mesh[0]["loss"] == one[0]["loss"] and mesh[0]["psnr"] == one[0]["psnr"]
    for step, (a, b) in enumerate(zip(mesh, one), start=1):
        assert set(a) == set(b), step
        assert abs(a["loss"] - b["loss"]) <= 1e-5, (step, a["loss"], b["loss"])
        assert abs(a["psnr"] - b["psnr"]) <= 1e-3, (step, a["psnr"], b["psnr"])
        assert a["dropped"] == b["dropped"] and a["clipped"] == b["clipped"], step
        if "alive" in b:
            assert [a[k] for k in REPORT] == [b[k] for k in REPORT], step
    rounds = [s for s, out in enumerate(one, start=1) if "alive" in out]
    assert rounds == [2, 4] and one[1]["cloned"] > 0, one


def test_rebalance_on_the_mesh(world):
    """An uneven store (the init fills the first block) is repacked once
    the threshold is on; the counts are kept, their spread is at most one,
    a second call does nothing, and the next step trains."""
    out = world[0][0]
    before, after = out["counts_before"], out["counts_after"]
    assert before.max() - before.min() > 0.25 * 128, before
    assert out["rebalanced"] and not out["again"]
    assert after.sum() == before.sum() and after.max() - after.min() <= 1, after
    assert np.isfinite(out["next_step"]["loss"])


def _assert_state_equal(a, b):
    for path, _, leaf in t_optim.labelled_leaves(a["params"]):
        np.testing.assert_array_equal(leaf, t_optim.tree_get(b["params"], path),
                                      err_msg=str(path))
    assert a["opt"]["count"] == b["opt"]["count"]
    for moment in ("mu", "nu"):
        for path, _, leaf in t_optim.labelled_leaves(a["opt"][moment]):
            np.testing.assert_array_equal(leaf, t_optim.tree_get(b["opt"][moment], path),
                                          err_msg=str(path))
    for x, y in zip(a["adc"], b["adc"]):
        np.testing.assert_array_equal(x, y)


def test_sharded_checkpoint_loads_into_a_one_device_trainer(world):
    out = world[0][0]
    _assert_state_equal(out["one_device_loaded"], out["saved"])
    a, b = out["one_device_next_step"], out["next_step"]
    assert abs(a["loss"] - b["loss"]) <= 1e-5, (a, b)


def test_one_device_checkpoint_loads_into_a_mesh_trainer(world):
    results = world[0]
    for r in results:
        _assert_state_equal(r["reloaded"], results[0]["saved"])
    a, b = results[0]["reloaded_next_step"], results[0]["one_device_next_step"]
    assert abs(a["loss"] - b["loss"]) <= 1e-5, (a, b)
