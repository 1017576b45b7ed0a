"""Port parity: models/losses.py and the two CRF priors of models/crf.py
against the JAX reference, values and gradients, on numpy-seeded images.

Tolerance: values atol 2e-6 (float32; torch's and lax's convolutions sum
the 11 or 33 taps in another order), gradients atol 1e-4 * scale + rtol
1e-3 with scale the largest gradient magnitude (SSIM's E[x^2] - E[x]^2
amplifies the convolutions' rounding in the backward)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.models import crf as t_crf
from casualhdrsplat_torch.models import losses as t_losses
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.models import crf as j_crf
from casualhdrsplat_tpu.models import losses as j_losses

VALUE_ATOL = 2e-6


def _pair(rng, h=40, w=36):
    """A smooth image and a perturbed copy, both in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = 0.5 + 0.4 * np.sin(xx[..., None] * 0.3 + yy[..., None] * 0.2 + np.arange(3))
    a = np.clip(base + rng.normal(0, 0.05, size=(h, w, 3)), 0, 1).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, size=(h, w, 3)), 0, 1).astype(np.float32)
    return a, b


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _value_and_grad_t(fn, a, b):
    leaf = _t(a).requires_grad_(True)
    val = fn(leaf, _t(b))
    (grad,) = torch.autograd.grad(val, leaf)
    return float(val.detach()), grad.numpy()


def _check(fn_t, fn_j, a, b, value_atol=VALUE_ATOL):
    val_t, grad_t = _value_and_grad_t(fn_t, a, b)
    val_j, grad_j = jax.jit(jax.value_and_grad(fn_j))(jnp.asarray(a), jnp.asarray(b))
    assert abs(val_t - float(val_j)) <= value_atol, (val_t, float(val_j))
    scale = float(np.abs(grad_j).max())
    assert scale > 0
    np.testing.assert_allclose(grad_t, grad_j, atol=1e-4 * scale, rtol=1e-3)


@pytest.mark.parametrize("name,fn_t,fn_j", [
    ("l1", t_losses.l1, j_losses.l1),
    ("ssim", t_losses.ssim, j_losses.ssim),
    ("ssim_unclamped", lambda a, b: t_losses.ssim(a, b, clamp=False),
     lambda a, b: j_losses.ssim(a, b, clamp=False)),
    ("d_ssim", t_losses.d_ssim, j_losses.d_ssim),
    ("photometric", lambda a, b: t_losses.photometric(a, b, 0.2),
     lambda a, b: j_losses.photometric(a, b, 0.2)),
    ("psnr", t_losses.psnr, j_losses.psnr),
])
def test_image_losses(rng, name, fn_t, fn_j):
    a, b = _pair(rng)
    # PSNR is in dB: 20 dB carries ~2e-6 of float32 rounding per unit
    _check(fn_t, fn_j, a, b, value_atol=2e-5 if name == "psnr" else VALUE_ATOL)


def test_ssim_cs_and_flat_bright_windows(rng):
    """Both outputs of _ssim_cs; and on a near-flat bright pair, where
    E[x^2] - E[x]^2 cancels, the clamp keeps SSIM <= 1 in both packages."""
    a, b = _pair(rng)
    for x, y in zip(t_losses._ssim_cs(_t(a), _t(b)),
                    jax.jit(j_losses._ssim_cs)(jnp.asarray(a), jnp.asarray(b))):
        assert abs(float(x) - float(y)) <= VALUE_ATOL
    flat = np.full((24, 24, 3), 0.97, np.float32)
    flat2 = flat + rng.normal(0, 1e-4, size=flat.shape).astype(np.float32)
    s_t = float(t_losses.ssim(_t(flat), _t(flat2)))
    s_j = float(j_losses.ssim(jnp.asarray(flat), jnp.asarray(flat2)))
    assert s_t <= 1.0 + 1e-6 and abs(s_t - s_j) <= 1e-4


@pytest.mark.parametrize("h,w,scales", [
    (96, 100, 4),  # 96 -> 48 -> 24 -> 12: four scales fit
    (40, 36, 2),  # 36 -> 18: two
    (20, 20, 1),  # too small to halve: plain SSIM
])
def test_ms_ssim(rng, h, w, scales):
    a, b = _pair(rng, h, w)
    _check(t_losses.ms_ssim, j_losses.ms_ssim, a, b, value_atol=1e-5)
    if scales == 1:
        assert abs(float(t_losses.ms_ssim(_t(a), _t(b)))
                   - float(t_losses.ssim(_t(a), _t(b)))) <= 1e-6


@pytest.mark.parametrize("sigma", [0.0, 0.005, 0.8, 3.0])
def test_gaussian_blur(rng, sigma):
    a, _ = _pair(rng, 24, 30)
    out_t = t_losses.gaussian_blur(_t(a), torch.tensor(sigma), k=19)
    out_j = jax.jit(lambda x, s: j_losses.gaussian_blur(x, s, k=19))(
        jnp.asarray(a), jnp.asarray(sigma, jnp.float32))
    np.testing.assert_allclose(out_t.numpy(), out_j, atol=VALUE_ATOL)
    if sigma <= 1e-2:  # the delta kernel: the identity, exactly
        np.testing.assert_array_equal(out_t.numpy(), a)
    # gradient with respect to the image, through an even k (made odd)
    w = rng.normal(size=a.shape).astype(np.float32)
    _check(lambda x, y: (t_losses.gaussian_blur(x, sigma, k=8) * y).sum(),
           lambda x, y: jnp.sum(j_losses.gaussian_blur(x, sigma, k=8) * y), a, w,
           value_atol=1e-4)


def test_exposure_prior(rng):
    le = rng.normal(size=7).astype(np.float32)
    init = rng.normal(size=7).astype(np.float32)
    _check(t_losses.exposure_prior, j_losses.exposure_prior, le, init)


@pytest.mark.parametrize("prior", ["smoothness_prior", "chroma_prior"])
def test_crf_priors(rng, prior):
    cfg_j, cfg_t = j_config.CRFConfig(hidden=8), t_config.CRFConfig(hidden=8)
    params_j = j_crf.create(cfg_j, jax.random.PRNGKey(0))
    np_params = {k: np.array(v) for k, v in params_j.items()}
    # channels pulled apart, so that the chroma prior has something to pull
    np_params["unit_w"] += rng.normal(0, 0.5, size=np_params["unit_w"].shape).astype(np.float32)
    np_params["gain"] += np.array([0.0, 0.3, -0.3], np.float32)
    val_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: getattr(j_crf, prior)(p, cfg_j)))({k: jnp.asarray(v)
                                                     for k, v in np_params.items()})
    leaves = {k: _t(v).requires_grad_(True) for k, v in np_params.items()}
    val_t = getattr(t_crf, prior)(leaves, cfg_t)
    grads_t = torch.autograd.grad(val_t, list(leaves.values()))
    assert float(val_j) > 0
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=1e-4, atol=1e-7)
    for (k, _), g_t in zip(leaves.items(), grads_t):
        scale = float(np.abs(grads_j[k]).max())
        np.testing.assert_allclose(g_t.numpy(), grads_j[k], atol=1e-4 * scale + 1e-9,
                                   rtol=1e-3, err_msg=k)
    # the non-learnable kinds have no prior
    assert float(getattr(t_crf, prior)({}, t_config.CRFConfig(kind="gamma"))) == 0.0
