"""The port's command line (casualhdrsplat_torch/cli.py) on the CPU
(`--device cpu`), at the sizes of tests/test_cli.py: train with
checkpoints -> render in every mode -> eval -> export, render with the
config rebuilt from config.json, `train --resume`, the refusals of
tests/test_cli.py::test_render_requires_checkpoint, the refusal of
`--device cuda` without a card, and the deblur render of
tests/test_colmap_integration.py on tests/fixtures/colmap_mini.

The commands run in this process through `cli.main` (one subprocess
checks `python -m casualhdrsplat_torch.cli`).  The synthetic source is
rendered once and reused: every command of the reference's flow loads the
same seeded fixture.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from casualhdrsplat_torch import cli
from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.train import checkpoint as ckpt
from casualhdrsplat_torch.train import metrics as t_metrics
from casualhdrsplat_torch.train.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO_ROOT, "tests", "fixtures", "colmap_mini")
# tests/test_cli.py's model, on the port's default backend
OVERRIDES = [
    "data.source=synthetic",
    "optim.max_steps=8",
    "model.max_gaussians=128",
    "model.num_virtual_views=2",
    "model.sh_degree=1",
    "model.rasterize.tile_h=8",
    "model.rasterize.tile_w=16",
    "model.rasterize.tile_capacity=64",
    "model.rasterize.chunk=32",
    "densify.enabled=false",
    "log_every=4",
    "eval_every=8",
    "checkpoint_every=4",
]


@pytest.fixture(scope="module", autouse=True)
def one_synthetic_render():
    cached = functools.lru_cache(maxsize=None)(t_dataset.make_synthetic_dataset)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_dataset, "make_synthetic_dataset", cached)
        yield


def run(*args):
    return cli.main(list(args))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A run of `train` (8 steps, checkpoints at 4 and 8): its checkpoint
    root."""
    out = tmp_path_factory.mktemp("cli") / "out"
    last = run("train", "--device", "cpu", "--preset", "default", *OVERRIDES, f"out_dir={out}")
    assert np.isfinite(last["loss"])
    return out / "casual-hdr-splat"


def test_train_writes_checkpoints_and_metrics(trained):
    assert sorted(p.name for p in trained.iterdir()) == [
        "config.json", "metrics.jsonl", "step_4", "step_8"]
    lines = (trained / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 and "mpix_s" in lines[0] and "eval_psnr" in lines[2]
    assert ckpt.latest_step_dir(str(trained)).endswith("step_8")


MODES = {
    "deblur": ["deblur_0000.png", "deblur_0001.png"],
    "hdr": ["hdr_0000.hdr", "hdr_0000.npy", "hdr_0001.hdr", "hdr_0001.npy"],
    "exposure-sweep": [f"sweep_{i:04d}_{j:02d}.png" for i in (0, 1) for j in range(3)],
    "blurred": ["blur_0000.png", "blur_0001.png"],
    "depth": ["anim.gif", "depth_0000.npy", "depth_0000.png", "depth_0001.npy",
              "depth_0001.png"],
    "novel": ["anim.gif", "novel_0000.png", "novel_0001.png", "novel_0002.png"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_render_modes(trained, tmp_path, mode):
    """Every render mode from config.json alone (no preset, no overrides),
    with a GIF where the reference's test makes one."""
    out = tmp_path / "r"
    args = ["render", "--device", "cpu", "--checkpoint", str(trained / "step_8"),
            "--mode", mode, "--frames", "0,1", "--out", str(out), "--path-n", "3",
            "--sweep-n", "3"]
    if mode in ("depth", "novel"):
        args += ["--gif", str(out / "anim.gif")]
    run(*args)
    assert sorted(os.listdir(out)) == MODES[mode]
    from PIL import Image

    for name in MODES[mode]:
        path = str(out / name)
        if name.endswith(".png"):
            img = np.asarray(Image.open(path))
            assert img.shape == (48, 48, 3) and img.max() > 0
        elif name.endswith(".npy"):
            arr = np.load(path)
            assert arr.shape[:2] == (48, 48) and np.isfinite(arr).all() and arr.min() >= 0
        elif name.endswith(".hdr"):
            npy = np.load(path[:-4] + ".npy")
            back = t_metrics.load_hdr(path)
            assert np.all(np.abs(back - npy) <= npy.max(-1, keepdims=True) * 2.0 ** -7 + 1e-30)
        elif name.endswith(".gif"):
            assert Image.open(path).n_frames == (3 if mode == "novel" else 2)


def test_render_with_preset_and_overrides(trained, tmp_path):
    """Naming the preset and repeating the overrides rebuilds the same
    config (tests/test_cli.py's first render)."""
    out = tmp_path / "r"
    run("render", "--device", "cpu", "--preset", "default", "--checkpoint",
        str(trained / "step_4"), "--mode", "deblur", "--frames", "0", "--out", str(out),
        *OVERRIDES)
    assert os.listdir(out) == ["deblur_0000.png"]


def test_eval_prints_metrics(trained, capsys):
    metrics = run("eval", "--device", "cpu", "--checkpoint", str(trained / "step_8"))
    for k in ("eval_psnr", "eval_ssim", "eval_ms_ssim", "eval_sharp_psnr", "eval_novel_psnr"):
        assert np.isfinite(metrics[k]), k
    assert "eval_lpips" not in metrics  # no lpips package here
    assert "eval_psnr" in capsys.readouterr().out


def test_export_writes_the_checkpoints_gaussians(trained, tmp_path):
    path = str(tmp_path / "g.ply")
    n = run("export", "--device", "cpu", "--checkpoint", str(trained / "step_8"), "--out", path)
    g = ckpt.restore(str(trained / "step_8"))["params"]["gaussians"]
    alive = g["alive"].numpy()
    assert n == int(alive.sum()) > 0
    back = ckpt.import_ply(path)
    for k in ("means", "sh_dc", "sh_rest", "opacity_logit", "log_scales"):
        np.testing.assert_array_equal(back[k], g[k].numpy()[alive], err_msg=k)


def test_train_resume(trained, tmp_path, capsys):
    """`train --resume` continues from the latest checkpoint of out_dir/name
    and saves on its own schedule."""
    import shutil

    root = tmp_path / "out" / "casual-hdr-splat"
    shutil.copytree(trained, root)
    overrides = [o for o in OVERRIDES if not o.startswith("optim.max_steps")]
    run("train", "--device", "cpu", "--resume", *overrides, "optim.max_steps=10",
        f"out_dir={tmp_path / 'out'}")
    assert "resumed from step 8" in capsys.readouterr().out
    assert ckpt.latest_step_dir(str(root)).endswith("step_10")
    assert ckpt.restore(str(root / "step_10"))["step"] == 10


REFUSALS = [
    ["render", "--mode", "deblur", "--out", "{tmp}/r"],
    ["eval"],
    ["export", "--out", "{tmp}/g.ply"],
    ["render", "--checkpoint", "", "--mode", "deblur", "--out", "{tmp}/r2"],
]


@pytest.mark.parametrize("cmd", REFUSALS, ids=["render", "eval", "export", "empty"])
def test_commands_require_checkpoint(tmp_path, cmd):
    args = [a.format(tmp=tmp_path) for a in cmd] + ["--device", "cpu", "data.source=synthetic"]
    with pytest.raises(SystemExit) as exc:
        run(*args)
    assert "--checkpoint" in str(exc.value.code)
    assert os.listdir(tmp_path) == []


def test_module_entry_point_refuses_in_a_process(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "casualhdrsplat_torch.cli", "export",
                        "--device", "cpu", "--out", str(tmp_path / "g.ply")],
                       capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode != 0 and "--checkpoint" in r.stderr
    assert os.listdir(tmp_path) == []


def test_cuda_device_without_a_card_refuses(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the refusal without one")
    with pytest.raises(SystemExit) as exc:
        run("train", *OVERRIDES, f"out_dir={tmp_path / 'out'}")  # --device cuda, the default
    assert "--device" in str(exc.value.code) and "cuda" in str(exc.value.code)
    assert os.listdir(tmp_path) == []


def test_deblur_render_on_colmap_mini(tmp_path):
    """tests/test_colmap_integration.py's flow: a Trainer on the committed
    COLMAP fixture, a checkpoint, and the CLI's deblur render of it with
    the config taken from config.json."""
    cfg = t_config.TrainConfig(name="colmap-mini")
    cfg.model.max_gaussians = 256
    cfg.model.sh_degree = 1
    cfg.model.num_virtual_views = 2
    cfg.model.crf.kind = "gamma"
    cfg.model.rasterize = t_config.RasterizeConfig(
        tile_h=8, tile_w=8, tile_capacity=128, max_tiles_per_gaussian=16, chunk=32)
    cfg.densify.enabled = False
    cfg.data = t_config.DataConfig(source="colmap", path=FIXTURE, eval_every=0)
    t = Trainer(cfg, device="cpu")
    for _ in range(2):
        assert np.isfinite(t.run_step()["loss"])
    step_dir = t.save(str(tmp_path / "run"))
    out = tmp_path / "render"
    run("render", "--device", "cpu", "--checkpoint", step_dir, "--mode", "deblur",
        "--out", str(out))
    assert sorted(os.listdir(out)) == ["deblur_0000.png", "deblur_0001.png", "deblur_0002.png"]
