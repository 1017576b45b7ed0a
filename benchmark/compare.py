"""The numbers that decide `correct`, and their limits.

Training: the program's and the reference's loss at each compared step
(the relative gap), and per parameter leaf the norm of the first
gradient and of the parameters' change over the compared steps, judged
by the worst leaf: |norm_program - norm_reference| / max(norm_reference
of the leaf, of the median leaf).  Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone and are
left out of both.  The first gradient of the leaves with a row per
Gaussian (those whose first dimension is the largest) is also compared
element by element (`grad_elem_gap`): ||g_program - g_reference|| /
||g_reference|| over the leaf's rows, the TRIM share of rows that differ
most left out, the worst leaf.  On a third of the seeds a few Gaussians
near a threshold (PERF.md section 4) carry nearly all of a sound run's
element-wise gap, and the leaves of a few numbers each (the spline, the
exposures, the CRF) take it in whole; the TF32 control's gap spreads over
the other rows too.  Serving: per kept request the relative L2 gap
||served - reference|| / ||reference|| of the image, the largest of them.
A reading that is not finite fails.
"""

from __future__ import annotations

import contextlib
import math
import statistics

import torch

NEGLIGIBLE = 1e-3  # of the median leaf's reference gradient
TRIM = 1e-3  # share of a Gaussian leaf's rows left out of grad_elem_gap


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Run the reference in full float32 (tf32 False) or with TF32 matrix
    products and convolutions (the control)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _gaps(program: dict, reference: dict, leaves) -> dict:
    median = statistics.median(reference[k] for k in leaves)
    return {k: abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in leaves}


def elem_gap(program: torch.Tensor, reference: torch.Tensor, trim: float) -> float:
    """||program - reference|| / ||reference|| over a leaf's rows, the
    ceil(trim * rows) rows that differ most left out (none where trim is 0)."""
    p = program.double().reshape(program.shape[0], -1) if program.dim() else program.double()
    r = reference.double().reshape(p.shape)
    if p.dim() < 2:
        p, r = p.reshape(-1, 1), r.reshape(-1, 1)
    d2 = (p - r).square().sum(1)
    r2 = r.square().sum(1)
    drop = math.ceil(trim * p.shape[0]) if trim > 0 else 0
    if drop:
        keep = torch.ones_like(d2, dtype=torch.bool)
        keep[torch.topk(d2, drop).indices] = False
        d2, r2 = d2[keep], r2[keep]
    return float(d2.sum().sqrt() / max(float(r2.sum().sqrt()), 1e-30))


def look(program: torch.Tensor, reference: torch.Tensor) -> dict:
    """Where a leaf's element-wise gap lies: the share of its squared norm
    in the 1, 16 and 131 rows that differ most, the gap with 0.01, 0.1 and
    1% of the rows left out, the rows that one side leaves at exactly 0,
    and the three worst rows (index, |g_reference|, |g_program|)."""
    p = program.double().reshape(program.shape[0], -1)
    r = reference.double().reshape(p.shape)
    d2 = (p - r).square().sum(1)
    top = torch.sort(d2, descending=True)
    total = max(float(d2.sum()), 1e-300)
    zp, zr = (p == 0).all(1), (r == 0).all(1)
    return {
        "top_share": [float(top.values[:k].sum()) / total for k in (1, 16, 131)],
        "trimmed": [elem_gap(program, reference, t) for t in (1e-4, 1e-3, 1e-2)],
        "zero_one_side": int((zp ^ zr).sum()),
        "worst_rows": [[int(i), float(r[i].norm()), float(p[i].norm())] for i in top.indices[:3]],
    }


def train_gaps(program: dict, reference: dict) -> dict:
    grad = reference["grad"]
    median = statistics.median(grad.values())
    leaves = [k for k, v in grad.items() if v >= NEGLIGIBLE * median]
    grads = _gaps(program["grad"], grad, leaves)
    changes = _gaps(program["change"], reference["change"], leaves)
    out = {
        "loss_gap": max(abs(p - r) / max(abs(r), 1e-30)
                        for p, r in zip(program["loss"], reference["loss"])),
        "grad_gap": max(grads.values()),
        "change_gap": max(changes.values()),
        "_worst": [max(grads, key=grads.get), max(changes, key=changes.get)],
        "_grad_gaps": grads, "_change_gaps": changes,
        "_left_out": sorted(set(grad) - set(leaves)),
    }
    if "grads" in program and "grads" in reference:
        pg, rg = program["grads"], reference["grads"]
        elem = {k: elem_gap(pg[k], rg[k], TRIM) for k in gaussian_leaves(rg) if k in leaves}
        out.update(grad_elem_gap=max(elem.values()), _grad_elem_gaps=elem,
                   _grad_diffs={k: elem_gap(pg[k], rg[k], 0.0) for k in leaves})
    return out


def gaussian_leaves(grads: dict) -> list:
    """The leaves with a row per Gaussian: those whose first dimension is
    the largest."""
    rows = max(v.shape[0] for v in grads.values() if v.dim())
    return [k for k, v in grads.items() if v.dim() and v.shape[0] == rows]


def serve_gaps(gaps, modes) -> dict:
    return {"image_gap": max(gaps) if gaps else math.inf, "_samples": len(gaps),
            "_hdr_samples": sum(m == "hdr" for m in modes)}


def judge(readings: dict, limits: dict):
    """(correct, {name: [reading, limit]}) over every limited reading."""
    checks, correct = {}, True
    for name, limit in limits.items():
        value = readings.get(name, math.inf)
        checks[name] = [value, limit]
        correct &= math.isfinite(value) and value <= limit
    return correct, checks
