"""Metrics, logging and image writers.  Counterpart of
casualhdrsplat_tpu/train/metrics.py: console + JSONL scalars (loss, PSNR,
throughput in Mpix/s), the gauge-aligned pose-recovery metrics (NumPy
float64, on host arrays), and the PNG and Radiance .hdr writers, which
take host arrays (`tensor.cpu().numpy()`)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

import numpy as np
import torch


class MetricsLogger:
    def __init__(self, out_dir: str, filename: str = "metrics.jsonl", echo: bool = True):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, filename)
        self._f = open(self.path, "a")
        self.echo = echo
        self._t0 = time.time()

    def log(self, step: int, **scalars: Any) -> None:
        rec: Dict[str, Any] = {"step": step, "t": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.echo:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("t",)
            )
            print(f"[{rec['t']:9.1f}s] {parts}", flush=True)

    def close(self) -> None:
        self._f.close()


def pose_recovery_errors(knots_gt, knots_est):
    """Gauge-aligned per-knot (rotation deg, translation) errors between
    two [M,4,4] camera-matrix stacks.

    Scene and cameras are free together, so the problem has a global
    sim(3) gauge and raw world-frame knot differences measure gauge drift,
    not pose quality.  Translation: Umeyama similarity alignment on camera
    centres, then the residual centre distances (the ATE protocol).
    Rotation: relative-pose error over consecutive knots, in which a
    global gauge rotation cancels.  Returns (rot_deg [M-1], trans [M])."""
    a = np.asarray(knots_gt, np.float64)
    b = np.asarray(knots_est, np.float64)
    ca = np.linalg.inv(a)[:, :3, 3]
    cb = np.linalg.inv(b)[:, :3, 3]
    mu_a, mu_b = ca.mean(0), cb.mean(0)
    xa, xb = ca - mu_a, cb - mu_b
    cov = xa.T @ xb / len(ca)
    U, S, Vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(U @ Vt))
    D = np.diag([1.0, 1.0, d])
    R_align = U @ D @ Vt  # maps est-centres into the GT frame
    var_b = (xb ** 2).sum() / len(ca)
    s = float(np.trace(np.diag(S) @ D) / max(var_b, 1e-12))
    cb_al = s * cb @ R_align.T + (mu_a - s * mu_b @ R_align.T)
    trans = np.linalg.norm(ca - cb_al, axis=-1)
    Ra, Rb = a[:, :3, :3], b[:, :3, :3]
    rel_a = np.einsum("nij,nkj->nik", Ra[:-1], Ra[1:])
    rel_b = np.einsum("nij,nkj->nik", Rb[:-1], Rb[1:])
    res = np.einsum("nij,nkj->nik", rel_a, rel_b)
    cos = np.clip((np.trace(res, axis1=1, axis2=2) - 1) / 2, -1, 1)
    rot_deg = np.degrees(np.arccos(cos))
    return rot_deg, trans


def trajectory_recovery_errors(
    knots_gt, t0_gt, dt_gt, knots_est, t0_est, dt_est, times, mode="cubic"
):
    """pose_recovery_errors evaluated at sampled trajectory times.

    Only the union of exposure windows is observed: knots in unsampled
    spline regions sit in the objective's null space and drift freely
    while every rendered pose stays right.  Evaluate both splines (in
    float32, as the reference does) at the times the data sampled and
    compare those poses.  Returns (rot_deg, trans) per time."""
    from casualhdrsplat_torch.geometry import spline

    def poses(knots, t0, dt):
        k = torch.as_tensor(np.asarray(knots, np.float32))
        t = torch.as_tensor(np.asarray(times, np.float32))
        return spline.interpolate(k, float(t0), float(dt), t, mode=mode).numpy()

    return pose_recovery_errors(poses(knots_gt, t0_gt, dt_gt),
                                poses(knots_est, t0_est, dt_est))


def exposure_window_times(timestamps, exposures, per_frame: int = 5):
    """Sample times covering every frame's exposure window [t_i, t_i+dt_i]:
    the observed support for trajectory_recovery_errors."""
    ts = np.asarray(timestamps, np.float64)
    ex = np.asarray(exposures, np.float64)
    frac = np.linspace(0.0, 1.0, per_frame)
    return np.concatenate([t + frac * e for t, e in zip(ts, ex)])


def save_hdr(path: str, img) -> None:
    """Write an [H,W,3] linear float image as Radiance .hdr (RGBE), flat
    scanlines without RLE, which every Radiance reader accepts."""
    arr = np.asarray(img, np.float32)
    h, w, _ = arr.shape
    v = np.maximum(arr.max(axis=-1), 1e-32)
    # v = m * 2^e with m in [0.5, 1); mantissa byte scale = m * 256 / v
    m, e = np.frexp(v)
    scale = m * 255.9999 / v
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(arr * scale[..., None] + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(arr.max(axis=-1) < 1e-32, 0, e + 128).astype(np.uint8)
    rgbe[..., :3][arr.max(axis=-1) < 1e-32] = 0
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_hdr(path: str) -> np.ndarray:
    """Read a flat-scanline Radiance .hdr back to [H,W,3] linear float."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"\n\n") + 2
    dim_end = data.index(b"\n", head_end)
    dims = data[head_end:dim_end].decode().split()
    h, w = int(dims[1]), int(dims[3])
    rgbe = np.frombuffer(data[dim_end + 1:], np.uint8).reshape(h, w, 4)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 128 - 8))
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def save_image(path: str, img, clip: bool = True) -> None:
    """Write an [H,W,3] float image as PNG through PIL; without PIL, as
    `path + ".npy"`."""
    arr = np.asarray(img)
    if clip:
        arr = np.clip(arr, 0.0, 1.0)
    try:
        from PIL import Image
    except ImportError:
        np.save(path + ".npy", arr)
        return
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)


class Timer:
    """Host-clock laps for the Mpix/s metric.  The caller ends the timed
    work with a device synchronisation (the trainer's per-step host read of
    its scalars is one)."""

    def __init__(self):
        self.t = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = now - self.t
        self.t = now
        return dt
