"""Operations and bytes that the traced work needs, frozen here so that
every later change is measured by the same arithmetic, and the peaks of
one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): float32 outside
the tensor cores (TF32 is off in the program) and HBM3 bandwidth.

Per (slot, pixel) pair of `work.Work.pairs`:
- alpha: dx, dy, five products and three sums of the conic form, the
  scale, min, exp, the opacity product, the clip and the threshold = 16;
- the forward blend: w = alpha T, four multiply-adds, T *= 1 - alpha = 10;
- the backward: w (1), the colour-gradient dot (7), the running suffix
  (2), 1 - alpha, tot - r, the division, T cg and their difference (5),
  the clip select and d power (2), the two mean gradients (5 each), the
  three conic gradients (4, 3, 4), the opacity gradient (2), the three
  colour gradients (6), the transmittance (1) = 47, after alpha again.
Bytes: every input byte once and every output byte once.  A needed slot
carries 9 float32 (mean 2, conic 3, opacity, colour 3) = 36 bytes, and
its gradient as many; a pixel's output is rgb and alpha (16 bytes), and
its upstream gradient as many; a dense list slot is a 4-byte id and the
rows it names are read once each.

The rest of a step, per element (float32 operations of the mathematics):
projection 180 a Gaussian and view, spherical harmonics of degree 3 150;
the CRF 7 a hidden unit and 10 more a pixel channel, forward; SSIM and
L1 on the blurred frame 250 a pixel channel; the views' mean 1 a pixel
channel and view; Adam 14 a parameter element.  A backward costs twice
its forward (the compositor's is counted above).
"""

from __future__ import annotations

from benchmark.counts.work import Work

FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

ALPHA_OPS, BLEND_OPS, BWD_OPS = 16, 10, 47
ROW_BYTES, PIXEL_BYTES, ID_BYTES = 36, 16, 4
PROJECT_OPS, SH_OPS = 180, 150
CRF_UNIT_OPS, CRF_PIXEL_OPS = 7, 10
LOSS_OPS, MEAN_OPS, ADAM_OPS = 250, 1, 14


def b1(w: Work):
    """(operations, bytes) of the packed forward."""
    return (ALPHA_OPS + BLEND_OPS) * w.pairs, ROW_BYTES * w.slots + PIXEL_BYTES * w.pixels


def b2(w: Work):
    """(operations, bytes) of the packed backward: the slots and the
    forward's output and upstream gradient in, the slots' gradients out."""
    return ((ALPHA_OPS + BWD_OPS) * w.pairs,
            2 * ROW_BYTES * w.slots + 2 * PIXEL_BYTES * w.pixels)


def b3(w: Work):
    """(operations, bytes) of the dense forward over id lists."""
    return ((ALPHA_OPS + BLEND_OPS) * w.pairs,
            ID_BYTES * w.slots + ROW_BYTES * w.rows + PIXEL_BYTES * w.pixels)


def b4(w: Work):
    """(operations, bytes) of the dense backward: ids, rows, output and
    upstream gradient in, the rows' gradients out."""
    return ((ALPHA_OPS + BWD_OPS) * w.pairs,
            ID_BYTES * w.slots + 2 * ROW_BYTES * w.rows + 2 * PIXEL_BYTES * w.pixels)


def roofline_seconds(ops: float, nbytes: float) -> float:
    """The least time the card needs: the larger of the two bounds."""
    return max(ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S)


def _forward_rest(w: Work, hidden: int) -> float:
    return ((PROJECT_OPS + SH_OPS) * w.gaussian_views
            + 3 * w.crf_pixels * (CRF_UNIT_OPS * hidden + CRF_PIXEL_OPS))


def step_ops(w: Work, hidden: int) -> float:
    """Operations of training steps: the compositor forward and backward,
    the rest forward and backward, the loss, Adam."""
    return ((ALPHA_OPS + BLEND_OPS + ALPHA_OPS + BWD_OPS) * w.pairs
            + 3 * _forward_rest(w, hidden)
            + 3 * 3 * (MEAN_OPS * w.pixels + LOSS_OPS * w.loss_pixels)
            + ADAM_OPS * w.params)


def render_ops(w: Work, hidden: int) -> float:
    """Operations of renders: the compositor forward and the rest."""
    return (ALPHA_OPS + BLEND_OPS) * w.pairs + _forward_rest(w, hidden)
