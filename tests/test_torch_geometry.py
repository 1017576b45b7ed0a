"""Port parity: geometry/lie.py, geometry/spline.py and geometry/camera.py
against the JAX reference, on the CPU, from numpy-seeded inputs.

Tolerance: atol 1e-6 (float32 on both sides; the same formulas, with
summation orders that can differ by an ulp or two)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch.geometry import camera as t_camera
from casualhdrsplat_torch.geometry import lie as t_lie
from casualhdrsplat_torch.geometry import spline as t_spline
from casualhdrsplat_tpu.geometry import camera as j_camera
from casualhdrsplat_tpu.geometry import lie as j_lie
from casualhdrsplat_tpu.geometry import spline as j_spline

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


def _tangents(rng, n=16):
    """Random se(3) tangents plus the small-angle and near-pi cases."""
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[0, :3] = 0.0  # identity rotation
    xi[1, :3] = [1e-5, -2e-5, 3e-6]  # Taylor branch of _sinc_coeffs
    xi[2, :3] = [0.0, 0.0, np.pi - 1e-3]  # near pi
    return xi


def test_so3_exp_log_and_hat(rng):
    xi = _tangents(rng)
    w = xi[:, :3]
    R_j = jax.vmap(j_lie.so3_exp)(jnp.asarray(w))
    R_t = t_lie.so3_exp(_t(w))
    _close(R_t, R_j)
    _close(t_lie.hat(_t(w)), jax.vmap(j_lie.hat)(jnp.asarray(w)))
    _close(t_lie.vee(t_lie.hat(_t(w))), w)
    _close(t_lie.so3_log(R_t), jax.vmap(j_lie.so3_log)(R_j), atol=2e-6)


@pytest.mark.parametrize("theta_sq", [0.0, 1e-12, 5e-9, 2e-8, 1e-4, 1.0, 9.0])
def test_sinc_coeffs_branches(theta_sq):
    ts = np.float32(theta_sq)
    for a, b in zip(t_lie._sinc_coeffs(torch.tensor(ts)), j_lie._sinc_coeffs(jnp.asarray(ts))):
        _close(a, b)


def test_se3_exp_log_inverse(rng):
    xi = _tangents(rng)
    T_j = j_lie.se3_exp_batch(jnp.asarray(xi))
    T_t = t_lie.se3_exp_batch(_t(xi))
    _close(T_t, T_j)
    _close(t_lie.se3_log(T_t), j_lie.se3_log_batch(T_j), atol=5e-6)
    _close(t_lie.se3_inverse(T_t), jax.vmap(j_lie.se3_inverse)(T_j))
    _close(t_lie.mat_mul(T_t, t_lie.se3_inverse(T_t)), np.broadcast_to(np.eye(4), T_t.shape))


def test_se3_exp_just_above_taylor_switch():
    """Just above theta^2 = 1e-8, C = (t - sin t)/t^3 cancels in float32 in
    both packages (t - sin t ~ 2e-12 against an ulp of t ~ 1.5e-11), so the
    translation V v carries the reference's own rounding noise of ~1e-4
    relative; the rotation is well conditioned and held at ATOL."""
    xi = np.array([[2e-4, 1e-4, -1e-4, 0.3, -0.8, 0.5]], np.float32)
    T_j = np.asarray(j_lie.se3_exp_batch(jnp.asarray(xi)))
    T_t = t_lie.se3_exp(_t(xi)).numpy()
    _close(T_t[:, :3, :3], T_j[:, :3, :3])
    _close(T_t[:, :3, 3], T_j[:, :3, 3], atol=3e-4)


def test_quat_to_rotmat_and_rt_to_mat(rng):
    q = rng.normal(size=(12, 4)).astype(np.float32) * 3.0
    R_j = j_lie.quat_to_rotmat(jnp.asarray(q))
    R_t = t_lie.quat_to_rotmat(_t(q))
    _close(R_t, R_j)
    _close(t_lie.rotmat_to_quat(R_t), jax.vmap(j_lie.rotmat_to_quat)(R_j))
    t = rng.normal(size=(12, 3)).astype(np.float32)
    _close(t_lie.rt_to_mat(R_t, _t(t)), j_lie.rt_to_mat(R_j, jnp.asarray(t)))


def _knots(rng, m=7):
    xi = (rng.normal(size=(m, 6)) * 0.3).astype(np.float32)
    xi[3] = xi[2]  # a repeated knot: identity relative pose
    return np.asarray(j_lie.se3_exp_batch(jnp.asarray(xi)))


@pytest.mark.parametrize("mode", ["cubic", "linear"])
def test_spline_interpolate(rng, mode):
    knots = _knots(rng)
    # the knots' span (queries past it extrapolate and amplify rounding)
    t = np.array([-2.0, -0.3, 0.0, 0.5, 1.0, 1.25, 1.999], np.float32)
    out_j = j_spline.interpolate(jnp.asarray(knots), -2.0, 1.0, jnp.asarray(t), mode=mode)
    out_t = t_spline.interpolate(_t(knots), -2.0, 1.0, _t(t), mode=mode)
    _close(out_t, out_j)


def test_virtual_times_and_grids(rng):
    _close(t_spline.sample_virtual_times(torch.tensor(1.5), 0.6, 8),
           j_spline.sample_virtual_times(jnp.asarray(1.5), 0.6, 8))
    tt, t0, dt = t_spline.dense_grid(5, 3, device="cpu")
    tj, j0, jd = j_spline.dense_grid(5, 3)
    _close(tt, tj)
    assert (t0, dt) == (j0, jd)
    knots = _knots(rng, 5)
    kt, k0, kd = t_spline.knots_for_frames(_t(knots))
    kj, j0, jd = j_spline.knots_for_frames(jnp.asarray(knots))
    _close(kt, kj)
    assert (k0, kd) == (j0, jd)
    rt, r0, rd = t_spline.resample_knots(kt, k0, kd, 5, 2)
    rj, s0, sd = j_spline.resample_knots(kj, j0, jd, 5, 2)
    _close(rt, rj)
    assert (r0, rd) == (s0, sd)


def test_camera_look_at():
    eye, target = (1.2, 0.6, -3.7), (0.1, -0.2, 0.3)
    _close(t_camera.look_at(eye, target, device="cpu"), j_camera.look_at(eye, target))
    cam_t = t_camera.Camera.make(np.eye(4), 50.0, 51.0, 16.0, 12.0, 32, 24, device="cpu")
    cam_j = j_camera.Camera.make(np.eye(4), 50.0, 51.0, 16.0, 12.0, 32, 24)
    assert (cam_t.width, cam_t.height) == (cam_j.width, cam_j.height)
    for f in ("fx", "fy", "cx", "cy"):
        _close(getattr(cam_t, f), getattr(cam_j, f))
    _close(cam_t.camtoworld(), cam_j.camtoworld())
