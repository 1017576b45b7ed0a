"""Casual-video ingestion.  Counterpart of casualhdrsplat_tpu/data/video.py,
its frame clock only: `timestamps_from_names`, which the COLMAP loader
uses to time a video's registered frames.  The ffmpeg and COLMAP helpers
(`extract_frames`, `prepare_video_dataset`, ...) are not ported yet
(ROADMAP.md queue A, "Data"); a video whose frames were extracted and
registered offline loads through `load_dataset(source="video")`.
"""

from __future__ import annotations

import os
import re
from typing import List

import numpy as np

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
