"""Port parity: the data layer for real captures (data/colmap.py,
data/undistort.py, data/_native.py, data/video.timestamps_from_names and
dataset.{_load_image, load_colmap_dataset, load_dataset}) against the JAX
package, on the committed tests/fixtures/colmap_mini and on the fixtures
tests/test_data.py writes for itself.

Both packages run the same NumPy code on the same files, so every array
is compared for equality; the undistortion checks keep the reference
test's own tolerances.
"""

import os

import numpy as np
import pytest

import test_data as fixtures
from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.data import _native as t_native
from casualhdrsplat_torch.data import colmap as t_colmap
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.data import undistort as t_und
from casualhdrsplat_torch.data import video as t_video
from casualhdrsplat_torch.train.trainer import Trainer
from casualhdrsplat_tpu.data import colmap as j_colmap
from casualhdrsplat_tpu.data import dataset as j_dataset
from casualhdrsplat_tpu.data import undistort as j_und
from casualhdrsplat_tpu.data import video as j_video
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "colmap_mini")
FIELDS = ("images", "timestamps", "viewmats", "points_xyz", "points_rgb", "fx", "fy", "cx",
          "cy", "width", "height", "train_indices", "eval_indices")


def _assert_same_dataset(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert np.asarray(x).dtype == np.asarray(y).dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.sharp_images is None and b.sharp_images is None


@pytest.mark.parametrize("downscale", [1, 2])
def test_colmap_mini_equals_reference(downscale):
    ds_t = t_dataset.load_colmap_dataset(FIXTURE, downscale=downscale)
    ds_j = j_dataset.load_colmap_dataset(FIXTURE, downscale=downscale)
    _assert_same_dataset(ds_t, ds_j)
    assert ds_t.images.shape == (5, 40 // downscale, 40 // downscale, 3)
    np.testing.assert_allclose(ds_t.timestamps, np.arange(5, dtype=np.float32))


@pytest.mark.parametrize("source", ["colmap", "video"])
def test_load_dataset_routes_captures(source):
    cfg = t_config.DataConfig(source=source, path=FIXTURE, eval_every=2)
    ds_t = t_dataset.load_dataset(cfg, device="cpu")
    ds_j = j_dataset.load_dataset(cfg)
    _assert_same_dataset(ds_t, ds_j)
    np.testing.assert_array_equal(ds_t.eval_indices, [0, 2, 4])


def test_colmap_binary_roundtrip(tmp_path):
    model_dir = str(tmp_path / "sparse" / "0")
    fixtures.write_fake_colmap_bin(model_dir)
    cams, images, xyz, rgb = t_colmap.load_model(model_dir)
    cams_j, images_j, xyz_j, rgb_j = j_colmap.load_model(model_dir)
    assert cams[1].model == "PINHOLE" and cams[1].pinhole() == (60.0, 61.0, 32.0, 24.0)
    assert cams[1].pinhole() == cams_j[1].pinhole() and len(images) == 2
    for k in images:
        assert images[k].name == images_j[k].name
        np.testing.assert_array_equal(images[k].viewmat(), images_j[k].viewmat())
    np.testing.assert_allclose(images[1].viewmat()[:3, 3], [0.1, 0.2, 0.3], atol=1e-6)
    np.testing.assert_array_equal(xyz, xyz_j)
    np.testing.assert_array_equal(rgb, rgb_j)
    np.testing.assert_allclose(rgb[0], [1.0, 128 / 255.0, 0.0], atol=1e-6)


def test_points3d_native_and_python_readers_agree(tmp_path, monkeypatch):
    """The port's ctypes loader finds the repo's native library when it has
    been built (`make -C native`) and reads what the Python reader reads."""
    model_dir = str(tmp_path / "m")
    fixtures.write_fake_colmap_bin(model_dir)
    path = os.path.join(model_dir, "points3D.bin")
    lib = t_native.load()  # None where the git-ignored library is not built
    with_lib = t_colmap.read_points3d_bin(path)
    monkeypatch.setattr(t_native, "load", lambda: None)
    plain = t_colmap.read_points3d_bin(path)
    for a, b in zip(with_lib, plain):
        np.testing.assert_array_equal(a, b)
    if lib is not None:
        for a, b in zip(t_native.read_points3d(lib, path), plain):
            np.testing.assert_array_equal(a, b)


def test_text_model_equals_reference(tmp_path):
    """The text form (cameras.txt / images.txt / points3D.txt), which
    chip_smoke.py writes its capture in."""
    d = tmp_path / "sparse" / "0"
    d.mkdir(parents=True)
    (d / "cameras.txt").write_text("# c\n1 PINHOLE 64 48 60.5 61.0 32.0 24.0\n")
    (d / "images.txt").write_text(
        "# i\n"
        "1 0.9 0.1 -0.2 0.3 0.5 -0.25 1.5 1 frame_0000.png\n3.0 4.0 1\n"
        "2 1 0 0 0 0.1 0.2 0.3 1 frame_0001.png\n1.0 2.0 -1\n")
    (d / "points3D.txt").write_text(
        "# p\n1 0.5 -1.25 3.0 255 128 0 0.1 1 0\n2 -0.5 0.25 2.0 10 20 30 0.2\n")
    got, want = t_colmap.load_model(str(d)), j_colmap.load_model(str(d))
    assert got[0][1].pinhole() == want[0][1].pinhole() == (60.5, 61.0, 32.0, 24.0)
    for k in (1, 2):
        assert got[1][k].name == want[1][k].name
        np.testing.assert_array_equal(got[1][k].viewmat(), want[1][k].viewmat())
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)
    assert got[2].shape == (2, 3)


def test_load_image_rgba_composites_background(tmp_path):
    from PIL import Image

    rgba = np.zeros((4, 4, 4), np.uint8)
    rgba[..., 0] = 200
    rgba[0, 0] = [200, 0, 0, 255]  # one opaque pixel, the rest transparent
    path = str(tmp_path / "t.png")
    Image.fromarray(rgba, "RGBA").save(path)
    for bg in (0.0, 1.0):
        got = t_dataset._load_image(path, background=bg)
        np.testing.assert_array_equal(got, j_dataset._load_image(path, background=bg))
        np.testing.assert_allclose(got[1, 1], [bg] * 3, atol=1e-6)
        np.testing.assert_allclose(got[0, 0], [200 / 255.0, 0.0, 0.0], atol=1e-6)


def test_load_image_downscale_area_averages(tmp_path):
    from PIL import Image

    img = np.zeros((5, 6, 3), np.uint8)
    img[::2, ::2] = 255
    img[1::2, 1::2] = 255
    path = str(tmp_path / "checker.png")
    Image.fromarray(img, "RGB").save(path)
    out = t_dataset._load_image(path, downscale=2)
    assert out.shape == (2, 3, 3)
    np.testing.assert_allclose(out, 0.5, atol=1e-6)
    np.testing.assert_array_equal(out, j_dataset._load_image(path, downscale=2))


def test_colmap_timestamps_from_registered_names(tmp_path):
    from PIL import Image

    model_dir = str(tmp_path / "sparse" / "0")
    fixtures.write_fake_colmap_bin(model_dir, names=(b"frame_000.png", b"frame_002.png"))
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for n in ("frame_000.png", "frame_002.png"):
        Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(str(img_dir / n))
    ds = t_dataset.load_colmap_dataset(str(tmp_path), fps=10.0)
    np.testing.assert_allclose(ds.timestamps, [0.0, 0.2], atol=1e-6)
    _assert_same_dataset(ds, j_dataset.load_colmap_dataset(str(tmp_path), fps=10.0))


@pytest.mark.parametrize("names", [
    ["IMG_20230401_123456.jpg", "IMG_20230402_091011.jpg", "IMG_20230402_151617.jpg"],
    ["a_1.png", "a_5000.png"],
    ["f_000.png", "f_001.png", "f_003.png"],
    ["frame_00010.png", "frame_00012.png", "frame_00020.png"],
    ["a.png", "b.png"],
])
def test_timestamps_from_names_match(names):
    for fps in (1.0, 10.0):
        np.testing.assert_array_equal(t_video.timestamps_from_names(names, fps),
                                      j_video.timestamps_from_names(names, fps))


def test_undistort_roundtrip_radial():
    """tests/test_data.py's case: a distorted capture of a smooth scene,
    made by iterative point undistortion, comes back onto the ideal
    pinhole view; both packages give the same arrays."""
    h, w = 48, 64
    fx = fy = 55.0
    cx, cy = w / 2.0, h / 2.0
    params = np.array([fx, cx, cy, -0.15])

    def scene(xn, yn):
        v = 0.5 + 0.3 * np.sin(4.0 * xn) * np.cos(5.0 * yn) + 0.15 * xn
        return np.repeat(np.clip(v, 0, 1)[..., None], 3, -1).astype(np.float32)

    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    xu, yu = t_und.undistort_points("SIMPLE_RADIAL", params, (u - cx) / fx, (v - cy) / fy)
    np.testing.assert_array_equal(
        xu, j_und.undistort_points("SIMPLE_RADIAL", params, (u - cx) / fx, (v - cy) / fy)[0])
    xd, yd = t_und.distort("SIMPLE_RADIAL", params, xu, yu)
    np.testing.assert_allclose(xd, (u - cx) / fx, atol=1e-9)
    np.testing.assert_allclose(yd, (v - cy) / fy, atol=1e-9)
    captured = scene(xu, yu)
    out = t_und.undistort_image(captured, "SIMPLE_RADIAL", params, fx, fy, cx, cy)
    np.testing.assert_array_equal(
        out, j_und.undistort_image(captured, "SIMPLE_RADIAL", params, fx, fy, cx, cy))
    ideal = scene((u - cx) / fx, (v - cy) / fy)
    assert np.abs(out[8:-8, 8:-8] - ideal[8:-8, 8:-8]).max() < 0.01


def test_undistort_identity_and_models():
    x = np.linspace(-0.4, 0.4, 9)
    y = np.linspace(-0.3, 0.3, 9)
    zero = {
        "SIMPLE_RADIAL": np.array([50, 10, 10, 0.0]),
        "RADIAL": np.array([50, 10, 10, 0.0, 0.0]),
        "OPENCV": np.array([50, 50, 10, 10, 0, 0, 0, 0.0]),
        "FULL_OPENCV": np.zeros(12) + [50, 50, 10, 10, 0, 0, 0, 0, 0, 0, 0, 0],
        "FOV": np.array([50, 50, 10, 10, 0.0]),
    }
    for model, p in zero.items():
        xd, yd = t_und.distort(model, p, x, y)
        np.testing.assert_allclose(xd, x, atol=1e-7)
        np.testing.assert_allclose(yd, y, atol=1e-7)
    bent = {
        "OPENCV": np.array([50, 50, 10, 10, -0.1, 0.01, 1e-3, -1e-3]),
        "OPENCV_FISHEYE": np.array([50, 50, 10, 10, -0.05, 0.01, 0, 0]),
        "SIMPLE_RADIAL_FISHEYE": np.array([50, 10, 10, -0.05]),
        "RADIAL_FISHEYE": np.array([50, 10, 10, -0.05, 0.01]),
        "FOV": np.array([50, 50, 10, 10, 0.6]),
    }
    for model, p in bent.items():
        xd, yd = t_und.distort(model, p, x + 0.3, y + 0.2)
        for a, b in zip((xd, yd), j_und.distort(model, p, x + 0.3, y + 0.2)):
            np.testing.assert_array_equal(a, b)
        assert np.abs(xd - (x + 0.3)).max() > 1e-4, model
        xu, yu = t_und.undistort_points(model, p, xd, yd)
        np.testing.assert_allclose(xu, x + 0.3, atol=1e-6)
        np.testing.assert_allclose(yu, y + 0.2, atol=1e-6)


def test_colmap_loader_undistorts(tmp_path):
    import struct

    from PIL import Image

    model_dir = str(tmp_path / "sparse" / "0")
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 2, 64, 48))  # model 2 = SIMPLE_RADIAL
        f.write(struct.pack("<4d", 55.0, 32.0, 24.0, -0.2))
    with open(os.path.join(model_dir, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<idddddddi", 1, 1.0, 0.0, 0.0, 0.0, 0, 0, 0, 1))
        f.write(b"frame_000.png\x00")
        f.write(struct.pack("<Q", 0))
    with open(os.path.join(model_dir, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", 0))
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    rng_img = np.random.default_rng(0).uniform(0, 255, (48, 64, 3))
    Image.fromarray(rng_img.astype(np.uint8)).save(str(img_dir / "frame_000.png"))
    ds = t_dataset.load_colmap_dataset(str(tmp_path))
    raw = t_dataset._load_image(str(img_dir / "frame_000.png"))
    assert not np.allclose(ds.images[0], raw)
    np.testing.assert_allclose(ds.images[0][24, 32], raw[24, 32], atol=0.03)
    _assert_same_dataset(ds, j_dataset.load_colmap_dataset(str(tmp_path)))


def test_trainer_steps_on_colmap_mini():
    """tests/test_colmap_integration.py's config: the config-driven loader
    feeds a Trainer whose steps stay finite and move the scene."""
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
    assert int(t.params["gaussians"]["alive"].sum()) == 120  # the model's points
    means = t.params["gaussians"]["means"].clone()
    losses = [t.run_step()["loss"] for _ in range(3)]
    assert np.all(np.isfinite(losses)), losses
    assert not np.array_equal(means.numpy(), t.params["gaussians"]["means"].numpy())
