"""Dataset container.  Counterpart of casualhdrsplat_tpu/data/dataset.py:

    Dataset -> {images[N,H,W,3], timestamps[N], intrinsics, init poses[N],
                sparse_points[M,3+3]}

as host-side numpy arrays; the trainer copies the images to its device
once.  Sources: the synthetic fixtures, COLMAP sparse models (with their
image directory), video frames registered offline by COLMAP
(data/video.py drives ffmpeg for the frames) and Blender / NeRF-synthetic
`transforms.json` scenes (data/blender.py).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from casualhdrsplat_torch.config import DataConfig
from casualhdrsplat_torch.data import colmap
from casualhdrsplat_torch.geometry.camera import Camera


@dataclass
class Dataset:
    images: np.ndarray  # [N,H,W,3] float32 in [0,1]
    timestamps: np.ndarray  # [N] float32 (seconds or frame units)
    viewmats: np.ndarray  # [N,4,4] world->cam init poses
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    points_xyz: np.ndarray  # [M,3] SfM sparse points
    points_rgb: np.ndarray  # [M,3] in [0,1]
    train_indices: np.ndarray = field(default=None)
    eval_indices: np.ndarray = field(default=None)
    # Ground-truth sharp LDR frames at each frame's mid-exposure pose, when
    # the source provides them (synthetic fixtures): they enable the
    # deblurred-render evaluation.
    sharp_images: Optional[np.ndarray] = None

    def __post_init__(self):
        n = len(self.images)
        if self.train_indices is None:
            self.train_indices = np.arange(n)
        if self.eval_indices is None:
            self.eval_indices = np.arange(0, n, max(n, 1))[:0]

    @property
    def num_frames(self) -> int:
        return len(self.images)

    def camera(self, index: Optional[int] = None, device="cuda") -> Camera:
        viewmat = self.viewmats[index] if index is not None else np.eye(4)
        return Camera.make(
            viewmat, self.fx, self.fy, self.cx, self.cy, self.width, self.height,
            device=device,
        )

    def split(self, eval_every: int) -> "Dataset":
        idx = np.arange(self.num_frames)
        if eval_every > 0:
            self.eval_indices = idx[::eval_every]
            self.train_indices = np.setdiff1d(idx, self.eval_indices)
        return self

    def downscaled(self, k: int) -> "Dataset":
        """A k-times-downscaled copy (area-average box filter, intrinsics
        scaled to match) sharing poses, timestamps and points: the coarse
        rung of a multi-resolution training curriculum.  Keeps the
        train/eval split."""
        if k <= 1:
            return self

        def box(imgs):
            if imgs is None:
                return None
            n, h, w, c = imgs.shape
            hd, wd = h // k, w // k
            x = imgs[:, : hd * k, : wd * k]
            return x.reshape(n, hd, k, wd, k, c).mean(axis=(2, 4)).astype(imgs.dtype)

        out = Dataset(
            images=box(self.images),
            timestamps=self.timestamps,
            viewmats=self.viewmats,
            fx=self.fx / k, fy=self.fy / k,
            cx=self.cx / k, cy=self.cy / k,
            width=self.width // k, height=self.height // k,
            points_xyz=self.points_xyz, points_rgb=self.points_rgb,
            sharp_images=box(self.sharp_images),
        )
        out.train_indices = self.train_indices
        out.eval_indices = self.eval_indices
        return out

    def scene_extent(self) -> float:
        if len(self.points_xyz):
            center = self.points_xyz.mean(axis=0)
            return float(np.quantile(np.linalg.norm(self.points_xyz - center, axis=1), 0.97))
        cams = self.viewmats[:, :3, 3]
        return float(np.linalg.norm(cams - cams.mean(0), axis=1).max() + 1.0)


def _load_image(path: str, downscale: int = 1, background: float = 0.0) -> np.ndarray:
    """Load an image as [H,W,3] float32 in [0,1] (imageio, else PIL).  RGBA
    inputs are alpha-composited onto `background` (rgb*a + (1-a)*bg:
    NeRF-synthetic frames carry meaning only in that form)."""
    try:
        import imageio.v3 as iio

        img = iio.imread(path)
    except ImportError:
        from PIL import Image

        img = np.asarray(Image.open(path))
    img = img.astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 4:
        alpha = img[..., 3:4]
        img = img[..., :3] * alpha + (1.0 - alpha) * background
    else:
        img = img[..., :3]
    if downscale > 1:
        # area average (box filter), not strided subsampling, which
        # aliases; trailing rows and columns that do not fill a block are
        # cropped (as the // of the intrinsics' scaling)
        h, w = img.shape[:2]
        hd, wd = h // downscale, w // downscale
        img = img[: hd * downscale, : wd * downscale]
        img = img.reshape(hd, downscale, wd, downscale, 3).mean(axis=(1, 3))
    return img


def load_colmap_dataset(
    path: str,
    images_dir: Optional[str] = None,
    downscale: int = 1,
    timestamps: Optional[np.ndarray] = None,
    fps: Optional[float] = None,
) -> Dataset:
    """Load a COLMAP reconstruction.  `path` contains `sparse/0` (or is the
    model dir itself); `images_dir` defaults to `<path>/images`.

    Frame timestamps default to the frame number parsed from each
    registered image name (divided by `fps` when given): right for
    constant-rate video frames even when SfM dropped some of them.  An
    explicit `timestamps` array must align with the registered images in
    name-sorted order.
    """
    model_dir = path
    for cand in ("sparse/0", "sparse", "."):
        d = os.path.join(path, cand)
        if os.path.exists(os.path.join(d, "cameras.bin")) or os.path.exists(
            os.path.join(d, "cameras.txt")
        ):
            model_dir = d
            break
    cams, col_images, xyz, rgb = colmap.load_model(model_dir)
    images_dir = images_dir or os.path.join(path, "images")

    ordered = sorted(col_images.values(), key=lambda im: im.name)
    cam0 = cams[ordered[0].camera_id]
    fx, fy, cx, cy = cam0.pinhole()
    s = 1.0 / downscale
    imgs: List[np.ndarray] = []
    viewmats: List[np.ndarray] = []
    uv_map = None
    undistorting = cam0.has_distortion()
    if undistorting:
        # resample onto the ideal pinhole grid so that the rasterizer's
        # pinhole camera stays exact; the sampling map depends only on the
        # camera: built once, reused for every frame
        from casualhdrsplat_torch.data import undistort as und
    for im in ordered:
        img = _load_image(os.path.join(images_dir, im.name), downscale)
        if undistorting:
            if uv_map is None:
                uv_map = und.undistort_map(
                    cam0.model, cam0.params, img.shape[1], img.shape[0],
                    fx * s, fy * s, cx * s, cy * s)
            img = und.undistort_image(
                img, cam0.model, cam0.params, fx * s, fy * s, cx * s, cy * s,
                uv_map=uv_map)
        imgs.append(img)
        viewmats.append(im.viewmat())
    if timestamps is None:
        from casualhdrsplat_torch.data.video import timestamps_from_names

        timestamps = timestamps_from_names([im.name for im in ordered], fps or 1.0)
    return Dataset(
        images=np.stack(imgs),
        timestamps=np.asarray(timestamps, np.float32),
        viewmats=np.stack(viewmats).astype(np.float32),
        fx=fx * s,
        fy=fy * s,
        cx=cx * s,
        cy=cy * s,
        width=imgs[0].shape[1],
        height=imgs[0].shape[0],
        points_xyz=xyz,
        points_rgb=rgb,
    )


def make_synthetic_dataset(seed: int = 0, device="cuda", **kwargs) -> Dataset:
    """Synthetic casual-video dataset (ground truth known), rendered on
    `device` by synthetic.make_casual_video and held as numpy arrays."""
    from casualhdrsplat_torch.data import synthetic

    rng = np.random.default_rng(seed)
    video = synthetic.make_casual_video(rng, device=device, **kwargs)
    n = video.images.shape[0]
    # frame-time poses: on the dense grid frame i sits at knot 2 + i*k
    kpf = int(kwargs.get("knots_per_frame", 1))
    knots = video.knots.cpu().numpy()
    cam = video.camera
    return Dataset(
        images=video.images.cpu().numpy(),
        timestamps=video.timestamps.cpu().numpy(),
        viewmats=np.stack([knots[2 + i * kpf] for i in range(n)]).astype(np.float32),
        fx=float(cam.fx),
        fy=float(cam.fy),
        cx=float(cam.cx),
        cy=float(cam.cy),
        width=cam.width,
        height=cam.height,
        points_xyz=video.cloud.means3d.cpu().numpy(),
        points_rgb=np.clip(video.cloud.colors.cpu().numpy(), 0.0, 1.0),
        sharp_images=video.sharp_ldr.cpu().numpy(),
    )


def load_dataset(cfg: DataConfig, device="cuda") -> Dataset:
    """The dataset `cfg` names.  `device` renders the synthetic fixture; a
    capture is read on the host."""
    if cfg.source == "synthetic":
        return make_synthetic_dataset(device=device).split(cfg.eval_every)
    if cfg.source in ("colmap", "video"):
        # a video's frames load once extracted and registered by COLMAP
        return load_colmap_dataset(cfg.path, downscale=cfg.downscale).split(cfg.eval_every)
    if cfg.source == "blender":
        from casualhdrsplat_torch.data.blender import load_blender_dataset

        return load_blender_dataset(cfg.path, downscale=cfg.downscale).split(cfg.eval_every)
    raise ValueError(f"unknown data source {cfg.source!r}")
