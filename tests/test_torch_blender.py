"""Port parity: data/blender.load_blender_dataset and
load_dataset(source="blender") against the reference on the same
transforms.json scenes.  Both are host-side numpy: every field is equal."""

import json
import os

import numpy as np
import pytest

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.data import blender as t_blender
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_tpu.data import blender as j_blender
from casualhdrsplat_tpu.data import dataset as j_dataset
from test_blender_depth import write_fake_blender

FIELDS = ("images", "timestamps", "viewmats", "points_xyz", "points_rgb", "fx", "fy", "cx",
          "cy", "width", "height", "train_indices", "eval_indices")


def _assert_same_dataset(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.sharp_images is None and b.sharp_images is None


def _write_scene(path, rgba=False, intrinsics=False, with_time=False, single_file=False,
                 n=4, size=12):
    """A transforms.json scene: RGBA frames with a varying alpha, explicit
    fl_x / fl_y / cx / cy instead of camera_angle_x, per-frame `time`,
    `transforms.json` instead of `transforms_train.json`; cameras on a
    rotated arc (OpenGL convention)."""
    from PIL import Image

    os.makedirs(path, exist_ok=True)
    rng = np.random.default_rng(3)
    frames = []
    for i in range(n):
        chans = 4 if rgba else 3
        img = (rng.uniform(size=(size, size, chans)) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(path, f"r_{i}.png"))
        a = 0.3 * i
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        c2w[:3, 3] = [3.0 * np.sin(a), 0.5, 3.0 * np.cos(a)]
        fr = {"file_path": f"./r_{i}" + (".png" if i % 2 else ""),
              "transform_matrix": c2w.tolist()}
        if with_time:
            fr["time"] = 0.25 * i
        frames.append(fr)
    meta = {"frames": frames}
    if intrinsics:
        meta.update(fl_x=14.0, fl_y=13.0, cx=6.5, cy=5.5)
    else:
        meta["camera_angle_x"] = 0.7
    name = "transforms.json" if single_file else "transforms_train.json"
    with open(os.path.join(path, name), "w") as f:
        json.dump(meta, f)


def test_reference_fake_scene(tmp_path):
    """The case of the reference's own loader test."""
    write_fake_blender(str(tmp_path))
    ds = t_blender.load_blender_dataset(str(tmp_path))
    _assert_same_dataset(ds, j_blender.load_blender_dataset(str(tmp_path)))
    assert ds.images.shape == (3, 8, 8, 3) and ds.num_frames == 3
    origin_cam = ds.viewmats[0][:3, 3]
    np.testing.assert_allclose(origin_cam[2], 3.0, atol=1e-5)
    assert ds.fx > 0 and ds.points_xyz.shape == (20_000, 3)


CASES = {
    "angle": dict(),
    "intrinsics": dict(intrinsics=True),
    "rgba": dict(rgba=True),
    "time": dict(with_time=True, single_file=True),
}
LOAD = {
    "default": dict(),
    "downscale": dict(downscale=2),
    "black_background": dict(white_background=False),
    "max_frames": dict(max_frames=2),
}


@pytest.mark.parametrize("load", list(LOAD))
@pytest.mark.parametrize("case", list(CASES))
def test_loader_equals_reference(tmp_path, case, load):
    _write_scene(str(tmp_path), **CASES[case])
    ds = t_blender.load_blender_dataset(str(tmp_path), **LOAD[load])
    _assert_same_dataset(ds, j_blender.load_blender_dataset(str(tmp_path), **LOAD[load]))
    assert ds.num_frames == (2 if load == "max_frames" else 4)


def test_missing_transforms_raises(tmp_path):
    for load in (t_blender.load_blender_dataset, j_blender.load_blender_dataset):
        with pytest.raises(FileNotFoundError, match="no transforms json"):
            load(str(tmp_path))


@pytest.mark.parametrize("downscale,eval_every", [(1, 2), (2, 0)])
def test_load_dataset_routes_blender(tmp_path, downscale, eval_every):
    _write_scene(str(tmp_path), rgba=True)
    cfg = t_config.DataConfig(source="blender", path=str(tmp_path), downscale=downscale,
                              eval_every=eval_every)
    ds = t_dataset.load_dataset(cfg, device="cpu")
    _assert_same_dataset(ds, j_dataset.load_dataset(cfg))
    assert ds.width == 12 // downscale
