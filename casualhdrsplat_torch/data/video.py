"""Casual-video ingestion.  Counterpart of casualhdrsplat_tpu/data/video.py.

The system takes a single casually captured video with auto exposure on.
Heavy preprocessing stays offline and external, as in the reference
lineage: ffmpeg extracts the frames, COLMAP reconstructs the poses.  This
module drives that preprocessing (where the binaries exist) and recovers
per-frame timestamps, which the continuous-time spline needs and a plain
image folder loses.  A video whose frames were extracted and registered
offline also loads through `load_dataset(source="video")`.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
from typing import List, Optional

import numpy as np


def have_binary(name: str) -> bool:
    return shutil.which(name) is not None


def probe_fps(video_path: str) -> float:
    """Frame rate via ffprobe (30.0 without it)."""
    if not have_binary("ffprobe"):
        return 30.0
    out = subprocess.run(
        [
            "ffprobe", "-v", "error", "-select_streams", "v:0",
            "-show_entries", "stream=r_frame_rate", "-of", "json", video_path,
        ],
        capture_output=True, text=True, check=True,
    )
    num, den = json.loads(out.stdout)["streams"][0]["r_frame_rate"].split("/")
    return float(num) / float(den)


def extract_frames(
    video_path: str,
    out_dir: str,
    fps: Optional[float] = None,
    max_frames: Optional[int] = None,
) -> List[str]:
    """ffmpeg frame extraction to PNG; returns the written file list."""
    if not have_binary("ffmpeg"):
        raise RuntimeError("ffmpeg not available; extract frames offline")
    os.makedirs(out_dir, exist_ok=True)
    args = ["ffmpeg", "-y", "-i", video_path]
    if fps:
        args += ["-vf", f"fps={fps}"]
    if max_frames:
        args += ["-frames:v", str(max_frames)]
    args += [os.path.join(out_dir, "frame_%05d.png")]
    subprocess.run(args, check=True, capture_output=True)
    return sorted(
        os.path.join(out_dir, f) for f in os.listdir(out_dir) if f.endswith(".png")
    )

_FRAME_RE = re.compile(r"(\d+)\D*$")


def timestamps_from_names(names: List[str], fps: float) -> np.ndarray:
    """Per-frame capture times from frame-numbered filenames.

    Uses the last number in each basename (frame_00042.png -> 42) so
    timestamps stay correct when SfM drops frames.  Falls back to ordinal
    position when the numbers do not look like a frame counter: missing
    on some names, non-increasing in name order, or implausibly sparse
    (photo sets named by date and time, e.g. IMG_20230401_123456.jpg,
    would otherwise give the SE(3) spline a garbage timeline).
    """
    ts = []
    for name in names:
        stem = os.path.splitext(os.path.basename(name))[0]
        m = _FRAME_RE.search(stem)
        ts.append(int(m.group(1)) if m else None)
    n = len(ts)
    counter_like = (
        n > 0
        and all(t is not None for t in ts)
        and all(b > a for a, b in zip(ts, ts[1:]))
        # a counter with SfM drops stays dense; > 16x average spacing
        # means these are date stamps or unrelated ids
        and (n < 2 or (max(ts) - min(ts)) <= 16 * (n - 1))
    )
    arr = np.asarray(ts if counter_like else range(n), np.float64)
    arr = arr - (arr.min() if n else 0.0)
    return (arr / fps).astype(np.float32)


def prepare_video_dataset(
    video_path: str,
    workdir: str,
    downscale: int = 1,
    max_frames: Optional[int] = None,
):
    """video -> frames (ffmpeg) -> COLMAP (external, run by the user) ->
    Dataset.

    Extracts the frames unless `workdir/images` already holds some; loads
    the COLMAP model under `workdir/sparse` (or `sparse/0`) with the
    timestamps of the registered frames, and raises if there is none yet.
    """
    from casualhdrsplat_torch.data.dataset import load_colmap_dataset

    frames_dir = os.path.join(workdir, "images")
    if not os.path.isdir(frames_dir) or not os.listdir(frames_dir):
        extract_frames(video_path, frames_dir, max_frames=max_frames)
    model_present = any(
        os.path.exists(os.path.join(workdir, "sparse", *sub, "cameras.bin"))
        for sub in ((), ("0",))
    )
    if not model_present:
        raise RuntimeError(
            f"no COLMAP model under {workdir}/sparse — run COLMAP on "
            f"{frames_dir} first (external preprocessing)"
        )
    # The timestamps come from the names of the registered images inside
    # load_colmap_dataset, not from this directory's listing: SfM often
    # drops blurry frames, and a listing would shift every later timestamp.
    return load_colmap_dataset(workdir, downscale=downscale, fps=probe_fps(video_path))
