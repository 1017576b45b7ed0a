"""Port parity: train/checkpoint.py, Trainer.save / Trainer.load and
parallel/distributed.resume_or_start.

- Save / restore / list / prune: the cases of tests/test_checkpoint.py run
  against the port; a round trip is bit-exact.
- PLY: `export_ply` writes the reference's bytes for the same parameters,
  and a PLY written by either package reads back in the other with equal
  arrays (exact: float32 stored as float32).
- Resume: a `Trainer.save` then a fresh `Trainer.load` continues bit for
  bit against an uninterrupted run, through a densify round that splits
  (so the split noise is drawn after the resume) on the dense path, and on
  the packed default.  On the CPU the plain compositors add in a fixed
  order, so every parameter, moment, statistic and scalar is equal.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.models import gaussians as t_gauss
from casualhdrsplat_torch.parallel.distributed import resume_or_start
from casualhdrsplat_torch.train import checkpoint as ckpt
from casualhdrsplat_torch.train import optim as t_optim
from casualhdrsplat_torch.train.trainer import Trainer
from casualhdrsplat_tpu.models import gaussians as j_gauss
from casualhdrsplat_tpu.train import checkpoint as j_ckpt
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_pytree_save_restore(tmp_path, rng):
    gen = torch.Generator().manual_seed(4)
    torch.rand(3, generator=gen)
    payload = {
        "params": {
            "a": torch.as_tensor(rng.normal(size=(4, 3)).astype(np.float32)),
            "nested": {"b": torch.arange(5), "alive": torch.tensor([True, False])},
            "empty": {},
        },
        "step": 7,
        "resume": {"gen": gen.get_state(), "rng": np.random.default_rng(2).bit_generator.state,
                   "floor": float("inf"), "armed": True},
    }
    path = str(tmp_path / "ck")
    ckpt.save(path, payload)
    out = ckpt.restore(path)
    assert torch.equal(out["params"]["a"], payload["params"]["a"])
    for k in ("b", "alive"):
        assert torch.equal(out["params"]["nested"][k], payload["params"]["nested"][k])
        assert out["params"]["nested"][k].dtype == payload["params"]["nested"][k].dtype
    assert out["params"]["empty"] == {} and out["step"] == 7
    assert torch.equal(out["resume"]["gen"], payload["resume"]["gen"])
    assert out["resume"]["rng"] == payload["resume"]["rng"]
    assert out["resume"]["floor"] == float("inf") and out["resume"]["armed"] is True
    # a second save replaces the first, through a temporary directory
    payload["step"] = 8
    ckpt.save(path, payload)
    assert ckpt.restore(path)["step"] == 8
    assert os.listdir(tmp_path) == ["ck"]


def test_latest_step_dir(tmp_path):
    assert ckpt.latest_step_dir(str(tmp_path)) is None
    for d in ("step_10", "step_200", "step_30"):
        (tmp_path / d).mkdir()
    assert ckpt.latest_step_dir(str(tmp_path)).endswith("step_200")


def test_latest_step_dir_skips_tmp(tmp_path):
    """A save cut short leaves `step_N.ckpt-tmp-<pid>`: resume must fall
    back to the last finalized step, and pruning sweeps the leftover and
    never touches foreign directories."""
    root = tmp_path / "ckpt"
    for d in ["step_100", "step_900", f"step_1000{ckpt.TMP_MARK}1755655",
              "step_bogus", "other"]:
        (root / d).mkdir(parents=True)
    assert ckpt.latest_step_dir(str(root)).endswith("step_900")
    assert ckpt.prune_step_dirs(str(root), keep=1) == 2
    assert sorted(os.listdir(root)) == ["other", "step_900", "step_bogus"]


def test_prune_step_dirs_protects_best(tmp_path):
    root = tmp_path / "ckpt"
    for n in (100, 200, 300, 400, 500):
        os.makedirs(root / f"step_{n}")
    (root / f"step_250{ckpt.TMP_MARK}9").mkdir()
    removed = ckpt.prune_step_dirs(str(root), keep=2, protect=100)
    assert sorted(os.listdir(root)) == ["step_100", "step_400", "step_500"]
    assert removed == 3  # steps 200, 300 and the leftover


# -- PLY interop ----------------------------------------------------------------


def _stores(rng, n_points, capacity, sh_degree):
    """The same Gaussian store in both packages (dead slots included),
    with unnormalised quaternions so that export normalises them."""
    g = j_gauss.create(rng.normal(size=(n_points, 3)), rng.uniform(size=(n_points, 3)),
                       capacity, sh_degree=sh_degree)
    np_g = {k: np.array(v) for k, v in g.items()}
    np_g["quats"] = (np_g["quats"] + rng.normal(size=np_g["quats"].shape)).astype(np.float32)
    np_g["sh_rest"] = rng.normal(size=np_g["sh_rest"].shape).astype(np.float32)
    np_g["alive"][::3] = False
    return ({k: jnp.asarray(v) for k, v in np_g.items()},
            {k: torch.as_tensor(v) for k, v in np_g.items()}, np_g)


@pytest.mark.parametrize("sh_degree", [0, 2, 3])
def test_export_ply_bytes_equal_reference(tmp_path, rng, sh_degree):
    g_j, g_t, np_g = _stores(rng, 20, 32, sh_degree)
    n_j = j_ckpt.export_ply(str(tmp_path / "j.ply"), g_j)
    n_t = ckpt.export_ply(str(tmp_path / "t.ply"), g_t)
    assert n_t == n_j == int(np_g["alive"].sum())
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ply_loads_in_either_package(tmp_path, rng, writer):
    g_j, g_t, np_g = _stores(rng, 20, 32, 3)
    path = str(tmp_path / "g.ply")
    (ckpt.export_ply(path, g_t) if writer == "port" else j_ckpt.export_ply(path, g_j))
    a, b = ckpt.import_ply(path), j_ckpt.import_ply(path)
    alive = np_g["alive"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        if k != "quats":
            np.testing.assert_array_equal(a[k], np_g[k][alive], err_msg=k)
    np.testing.assert_allclose(np.linalg.norm(a["quats"], axis=-1), 1.0, atol=1e-6)


def test_ply_header_3dgs_convention(tmp_path, rng):
    g = t_gauss.create(rng.normal(size=(5, 3)), rng.uniform(size=(5, 3)), 8, sh_degree=3,
                       device="cpu")
    path = str(tmp_path / "g.ply")
    assert ckpt.export_ply(path, g) == 5
    header = open(path, "rb").read(4096).split(b"end_header")[0].decode()
    for prop in ("f_dc_0", "f_rest_44", "opacity", "scale_2", "rot_3"):
        assert f"property float {prop}" in header
    assert "element vertex 5" in header and "binary_little_endian" in header


# -- Trainer.save / Trainer.load ------------------------------------------------


def _resume_cfg(packed: bool):
    cfg = t_config.TrainConfig(name="resume")
    cfg.model.max_gaussians = 128
    cfg.model.sh_degree = 1
    cfg.model.num_virtual_views = 2
    cfg.model.crf = t_config.CRFConfig(kind="mlp", hidden=8)
    if packed:
        cfg.model.rasterize = t_config.RasterizeConfig(tile_h=8, tile_w=16, chunk=32)
    else:
        cfg.model.rasterize = t_config.RasterizeConfig(
            tile_h=8, tile_w=16, tile_capacity=128, max_tiles_per_gaussian=32, chunk=32,
            packed=False)
    d = cfg.densify
    d.start_iter, d.stop_iter, d.interval = 2, 6, 2
    d.opacity_reset_interval = 5
    d.screen_prune_from = 1
    d.prune_screen_radius = 0.3
    d.grad_threshold = 4e-3
    d.sh_degree_interval = 3
    cfg.optim.max_steps = 25
    cfg.log_every = 10**9
    cfg.eval_every = 0
    cfg.checkpoint_every = 0
    cfg.data.eval_every = 0
    return cfg


@pytest.fixture(scope="module")
def resume_dataset():
    return t_dataset.make_synthetic_dataset(seed=6, n_gaussians=80, n_frames=4, n_virtual=2,
                                            size=32, device="cpu")


def _state(t):
    """Everything a step reads or writes, flattened."""
    out = {"/".join(p): leaf for p, _, leaf in t_optim.labelled_leaves(t.params)}
    for m in ("mu", "nu"):
        out.update({f"{m}/" + "/".join(p): leaf
                    for p, _, leaf in t_optim.labelled_leaves(t.opt_state[m])})
    out.update({f"adc/{k}": v for k, v in t.adc._asdict().items()})
    return out


@pytest.mark.parametrize("packed", [False, True], ids=["dense", "packed"])
def test_resume_continues_bit_for_bit(resume_dataset, tmp_path, packed):
    steps, cut = 7, 3
    ref = Trainer(_resume_cfg(packed), resume_dataset, device="cpu")
    ref_out = [ref.run_step() for _ in range(steps)]
    rounds = [o for o in ref_out[cut:] if "alive" in o]
    # the continuation crosses densify rounds that clone and split (split
    # noise drawn after the resume) and the opacity reset at step 5
    assert rounds and sum(o["split"] for o in rounds) > 0, ref_out

    first = Trainer(_resume_cfg(packed), resume_dataset, device="cpu")
    for _ in range(cut):
        first.run_step()
    path = first.save(str(tmp_path / "run"))
    assert os.path.basename(path) == f"step_{cut}"
    del first
    resumed = Trainer(_resume_cfg(packed), resume_dataset, device="cpu")
    assert resume_or_start(resumed, str(tmp_path / "run")) == cut
    out = [resumed.run_step() for _ in range(steps - cut)]
    assert out == ref_out[cut:]
    a, b = _state(resumed), _state(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert resumed.opt_state["count"] == ref.opt_state["count"] == steps


def test_resume_or_start_without_checkpoint(resume_dataset, tmp_path):
    t = Trainer(_resume_cfg(True), resume_dataset, device="cpu")
    assert resume_or_start(t, str(tmp_path / "nothing")) == 0 and t.step == 0


def test_config_json_rewritten_on_every_save(resume_dataset, tmp_path):
    cfg = _resume_cfg(True)
    t = Trainer(cfg, resume_dataset, device="cpu")
    root = tmp_path / "run"
    t.save(str(root))
    (root / "config.json").write_text("{truncated")
    t.run_step()
    cfg.name = "renamed"
    t.save(str(root))
    saved = json.loads((root / "config.json").read_text())
    assert saved == t_config.to_dict(cfg) and saved["name"] == "renamed"
    assert t_config.from_dict(saved) == cfg
    assert sorted(os.listdir(root)) == ["config.json", "step_0", "step_1"]
