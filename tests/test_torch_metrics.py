"""Port parity: train/metrics.py (pose-recovery metrics, the .hdr and PNG
writers) against the JAX package, and utils/profiling.py's trace writer
(its spans and marks: tests/test_torch_tracing.py).

Tolerances.
- pose_recovery_errors and exposure_window_times run the reference's
  NumPy float64 arithmetic on the same arrays: equal to 1e-12.
- trajectory_recovery_errors evaluates both splines in float32 (torch and
  XLA round the spline differently): translation 2e-5, rotation 0.05
  degrees.  An angle comes out of arccos((trace - 1) / 2), which turns the
  float32 rounding of a pose (~3e-7 in the cosine) into up to ~0.045
  degrees where the true angle is 0; 0.05 degrees is also the reference
  test's own floor for "no error".  Where the errors are real (a degree
  and more) the two agree far closer: rtol 1e-3.
- save_hdr and save_image: the same bytes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_pose_metrics as fixtures
from casualhdrsplat_torch.geometry import lie as t_lie
from casualhdrsplat_torch.train import metrics as t_metrics
from casualhdrsplat_torch.utils import profiling
from casualhdrsplat_tpu.geometry import spline as j_spline
from casualhdrsplat_tpu.train import metrics as j_metrics
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _noisy_pairs():
    """(gt, estimate) knot stacks: a pure sim(3) gauge, rotation noise and
    centre noise, from the reference test's own generators."""
    rng = np.random.default_rng(1)
    knots = fixtures._trajectory(rng)
    gauged = fixtures._apply_sim3_gauge(knots, fixtures._expm(rng, 0.5), rng.normal(size=3), 1.3)
    noisy = gauged.copy()
    for i in range(len(knots)):
        noisy[i, :3, :3] = fixtures._expm(rng, 0.05) @ noisy[i, :3, :3]
        R = noisy[i, :3, :3]
        c = -R.T @ noisy[i, :3, 3] + rng.normal(size=3) * 0.05
        noisy[i, :3, 3] = -R @ c
    return [(knots, gauged), (knots, noisy)]


@pytest.mark.parametrize("case", [0, 1], ids=["gauge", "noise"])
def test_pose_recovery_errors_match(case):
    gt, est = _noisy_pairs()[case]
    for a, b in zip(t_metrics.pose_recovery_errors(gt, est),
                    j_metrics.pose_recovery_errors(gt, est)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    if case:
        assert t_metrics.pose_recovery_errors(gt, est)[0].mean() > 1.0


def test_exposure_window_times_match():
    args = ([0.0, 1.0, 2.5], [0.4, 0.2, 0.7])
    np.testing.assert_allclose(t_metrics.exposure_window_times(*args, per_frame=4),
                               j_metrics.exposure_window_times(*args, per_frame=4),
                               rtol=0, atol=1e-12)


def test_trajectory_recovery_errors_match():
    """tests/test_pose_metrics.py's null-space case: a pad knot far outside
    the sampled windows perturbed wildly (no error), a knot inside them
    perturbed (a degree-scale error); both packages agree on each."""
    times_k, t0, dt = j_spline.dense_grid(num_frames=4, per_frame=3, pad=2)
    m = times_k.shape[0]
    rng = np.random.default_rng(0)
    gt = t_lie.se3_exp(torch.as_tensor(rng.normal(0, 0.05, (m, 6)).astype(np.float32)))
    kick = t_lie.se3_exp(torch.tensor([0.5, -0.4, 0.3, 1.0, -1.0, 0.5]))
    outside = gt.clone()
    outside[0] = gt[0] @ kick
    inside = gt.clone()
    inside[m // 2] = gt[m // 2] @ t_lie.se3_exp(torch.tensor([0.1, 0.0, 0.0, 0.0, 0.0, 0.0]))
    q = t_metrics.exposure_window_times([1.0, 2.0], [0.5, 0.5], per_frame=5)
    for est, worst in ((outside, 0.05), (inside, None)):
        rot_t, trans_t = t_metrics.trajectory_recovery_errors(
            gt.numpy(), float(t0), float(dt), est.numpy(), float(t0), float(dt), q)
        rot_j, trans_j = j_metrics.trajectory_recovery_errors(
            jnp.asarray(gt.numpy()), float(t0), float(dt), jnp.asarray(est.numpy()),
            float(t0), float(dt), jnp.asarray(q, jnp.float32))
        np.testing.assert_allclose(rot_t, rot_j, rtol=0, atol=0.05)
        np.testing.assert_allclose(trans_t, trans_j, rtol=0, atol=2e-5)
        if worst is None:
            assert rot_t.max() > 0.5
            real = rot_j > 0.5
            np.testing.assert_allclose(rot_t[real], rot_j[real], rtol=1e-3)
        else:
            assert rot_t.max() < worst and trans_t.max() < 1e-4


def _hdr_image(rng):
    img = rng.lognormal(0.0, 2.0, size=(7, 9, 3)).astype(np.float32)
    img[0, 0] = 0.0  # black
    img[1, 1] = [1e-35, 0.0, 0.0]  # below the format's range
    img[2, 2] = [6e4, 1.0, 0.5]
    return img


def test_save_hdr_bytes_equal_reference(tmp_path, rng):
    img = _hdr_image(rng)
    t_metrics.save_hdr(str(tmp_path / "t.hdr"), img)
    j_metrics.save_hdr(str(tmp_path / "j.hdr"), img)
    assert (tmp_path / "t.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    back = t_metrics.load_hdr(str(tmp_path / "t.hdr"))
    np.testing.assert_array_equal(back, j_metrics.load_hdr(str(tmp_path / "j.hdr")))
    # RGBE keeps 8 bits of mantissa against the pixel's largest channel
    peak = img.max(axis=-1, keepdims=True)
    assert np.all(np.abs(back - img) <= peak * 2.0 ** -7 + 1e-30)


def test_save_image_bytes_equal_reference(tmp_path, rng):
    img = rng.uniform(-0.2, 1.2, size=(6, 5, 3)).astype(np.float32)
    t_metrics.save_image(str(tmp_path / "t.png"), img)
    j_metrics.save_image(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("step", 3):
            torch.ones(8).sum()
    (path,) = (tmp_path / "tr").iterdir()
    text = path.read_text()
    assert path.suffix == ".json" and "traceEvents" in text and '"chs.step"' in text
