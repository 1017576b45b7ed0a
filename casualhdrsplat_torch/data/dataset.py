"""Dataset container.  Counterpart of casualhdrsplat_tpu/data/dataset.py:

    Dataset -> {images[N,H,W,3], timestamps[N], intrinsics, init poses[N],
                sparse_points[M,3+3]}

as host-side numpy arrays; the trainer copies the images to its device
once.  Sources: the synthetic fixtures.  The COLMAP, Blender and video
loaders are not ported yet (ROADMAP.md queue A, "Data").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from casualhdrsplat_torch.config import DataConfig
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
    if cfg.source == "synthetic":
        return make_synthetic_dataset(device=device).split(cfg.eval_every)
    if cfg.source in ("colmap", "video", "blender"):
        raise NotImplementedError(
            f"data source {cfg.source!r}: the loaders are not ported yet "
            "(ROADMAP.md queue A, 'Data')"
        )
    raise ValueError(f"unknown data source {cfg.source!r}")
