"""Perceptual metric (LPIPS), gated.  Counterpart of
casualhdrsplat_tpu/models/perceptual.py.

LPIPS needs the `lpips` package and its pretrained AlexNet weights; where
the package is absent (no weights are fetched) `available()` is False and
evaluators omit the `eval_lpips` key.  PSNR and SSIM (models/losses.py)
always report.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np
import torch


def available() -> bool:
    return _load() is not None


@lru_cache(maxsize=1)
def _load():
    try:
        import lpips as lpips_pkg  # type: ignore
    except ImportError:
        return None
    net = lpips_pkg.LPIPS(net="alex")

    def fn(a: np.ndarray, b: np.ndarray) -> float:
        ta = torch.from_numpy((a * 2 - 1).transpose(2, 0, 1)[None]).float()
        tb = torch.from_numpy((b * 2 - 1).transpose(2, 0, 1)[None]).float()
        with torch.no_grad():
            return float(net(ta, tb))

    return fn


def lpips(a: np.ndarray, b: np.ndarray) -> Optional[float]:
    """[H,W,3] float images in [0,1] -> LPIPS distance, or None where the
    pretrained backbone is unavailable."""
    fn = _load()
    if fn is None:
        return None
    return fn(np.asarray(a, np.float32), np.asarray(b, np.float32))
