"""Checkpoint / resume and PLY export.  Counterpart of
casualhdrsplat_tpu/train/checkpoint.py.

A checkpoint is a directory `step_<N>` holding one `torch.save` file of
the training state {params, optimizer state, density-control statistics,
step, ...}: tensors, dicts, lists, strings and Python numbers only, so
`torch.load(weights_only=True)` reads it back (a NamedTuple such as
AdcState is stored as its `_asdict()`).  A save writes the directory under
a temporary name and renames it into place, so a save cut short leaves a
`step_<N>.ckpt-tmp-…` directory that `latest_step_dir` skips and
`prune_step_dirs` removes, never a half-written `step_<N>`: the reference
gets the same from orbax's temporary directories.

The PLY exporter writes the 3DGS convention byte for byte as the
reference does, so a trained scene loads in the wider splatting ecosystem
and in either package.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"
# infix of a directory a save is still writing (or was cut short in)
TMP_MARK = ".ckpt-tmp-"


def save(path: str, payload: Dict[str, Any]) -> None:
    """Write `payload` as the checkpoint directory `path`, replacing any
    checkpoint already there."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}{TMP_MARK}{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if os.path.isdir(path):
        # os.replace cannot move a directory onto a non-empty one
        old = f"{path}{TMP_MARK}old-{os.getpid()}"
        os.replace(path, old)
        shutil.rmtree(old)
    os.replace(tmp, path)


def restore(path: str, map_location=None) -> Dict[str, Any]:
    """The payload `save` wrote to `path`, its tensors on `map_location`
    (their saved devices when None)."""
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE),
                      map_location=map_location, weights_only=True)


def _finalized_step_dirs(root: str) -> list:
    """step_<N> checkpoint dirs under root, finalized only: a save cut short
    leaves `step_N.ckpt-tmp-<pid>`, whose non-numeric suffix must not be
    read as a step.  Fully-numeric suffixes only."""
    out = []
    for d in os.listdir(root):
        stem = d[len("step_"):]
        if d.startswith("step_") and stem.isdigit():
            out.append((int(stem), os.path.join(root, d)))
    return sorted(out)


def latest_step_dir(root: str) -> Optional[str]:
    if not os.path.isdir(root):
        return None
    steps = _finalized_step_dirs(root)
    return steps[-1][1] if steps else None


def prune_step_dirs(root: str, keep: int = 3, protect: "int | None" = None) -> int:
    """Delete all but the newest `keep` finalized step_<N> dirs plus any
    temporary leftovers of saves cut short.  Returns the number of
    directories removed.

    `protect` keeps one additional step dir regardless of age (the
    best-eval checkpoint of a run whose tail diverged)."""
    if not os.path.isdir(root) or keep < 1:
        return 0
    doomed = [p for n, p in _finalized_step_dirs(root)[:-keep] if n != protect]
    doomed += [os.path.join(root, d) for d in os.listdir(root) if TMP_MARK in d]
    for p in doomed:
        shutil.rmtree(p, ignore_errors=True)
    return len(doomed)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def export_ply(path: str, gauss: Dict[str, Any]) -> int:
    """Write alive Gaussians as a 3DGS-ecosystem binary_little_endian PLY
    (property names follow the de-facto splatting convention).  The
    quaternions are normalised in NumPy, as the reference does, so that
    both packages write the same bytes for the same parameters."""
    alive = _numpy(gauss["alive"])
    means = _numpy(gauss["means"])[alive]
    quats = _numpy(gauss["quats"])[alive]
    quats = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-8)
    log_scales = _numpy(gauss["log_scales"])[alive]
    opac = _numpy(gauss["opacity_logit"])[alive]
    sh_dc = _numpy(gauss["sh_dc"])[alive]  # [n,1,3]
    sh_rest = _numpy(gauss["sh_rest"])[alive]  # [n,K-1,3]
    n = means.shape[0]
    n_rest = sh_rest.shape[1] * 3

    props = ["x", "y", "z", "nx", "ny", "nz"]
    props += [f"f_dc_{i}" for i in range(3)]
    props += [f"f_rest_{i}" for i in range(n_rest)]
    props += ["opacity"] + [f"scale_{i}" for i in range(3)] + [f"rot_{i}" for i in range(4)]

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {p}\n" for p in props)
        + "end_header\n"
    )
    # channel-major f_rest layout, as written by the reference lineage
    rest = sh_rest.transpose(0, 2, 1).reshape(n, n_rest)
    rows = np.concatenate(
        [
            means,
            np.zeros((n, 3), np.float32),
            sh_dc.reshape(n, 3),
            rest,
            opac[:, None],
            log_scales,
            quats,
        ],
        axis=1,
    ).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rows.tobytes())
    return n


def import_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a 3DGS-convention PLY back into plain arrays (for interop and
    round-trip tests)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode("ascii").splitlines()
        n = next(int(l.split()[-1]) for l in lines if l.startswith("element vertex"))
        props = [l.split()[-1] for l in lines if l.startswith("property")]
        data = np.frombuffer(f.read(), dtype="<f4").reshape(n, len(props))
    cols = {p: data[:, i] for i, p in enumerate(props)}
    n_rest = sum(1 for p in props if p.startswith("f_rest_"))
    rest = np.stack([cols[f"f_rest_{i}"] for i in range(n_rest)], axis=1)
    k_rest = n_rest // 3
    return {
        "means": np.stack([cols["x"], cols["y"], cols["z"]], axis=1),
        "sh_dc": np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=1)[:, None, :],
        "sh_rest": rest.reshape(n, 3, k_rest).transpose(0, 2, 1),
        "opacity_logit": cols["opacity"],
        "log_scales": np.stack([cols[f"scale_{i}"] for i in range(3)], axis=1),
        "quats": np.stack([cols[f"rot_{i}"] for i in range(4)], axis=1),
    }
