"""Kernel T1 (casualhdrsplat_torch/ops/crf_fused.py): the CRF's monotone
MLP as one fused pass, and its closed-form backward.

On the CPU (`crf.apply` runs the plain forward and the closed-form
backward there):
- the closed-form backward against torch autograd of the plain chain
  (`crf._norm_log` and `crf._monotone_mlp`) away from the clamps' ties:
  atol 1e-6 x the group's largest gradient + rtol 1e-5.  The two sum the
  same float32 terms in another order (measured: 2e-7 of the largest);
- `crf.apply`'s forward and gradients (the image, and the five raw
  parameters through softplus) against the reference's `crf.apply` under
  `jax.jit` / `jax.grad`, the same parameters from numpy, hidden 8 and 32,
  inputs at 0, below 0, near 0 and past exp(log_max): forward atol 1e-6 (as
  tests/test_torch_crf.py holds `apply`); gradients atol 1e-6 x the
  largest + rtol 1e-4 (XLA's and torch's log, exp and sums round
  differently: measured 2e-7 of the largest).  At x = 0 both take half the
  gradient (`jnp.maximum`'s rule, which torch.clamp's autograd does not
  follow), and that is compared too.

On the card (marked `cuda`, skipped here): the kernel against the plain
versions, forward atol 1e-5 (Triton's exp, log and division are the
approximate hardware ones, a few ulp each, and the unit sum runs in
another order over up to 32 weighted units), backward every group within
1e-4 x its largest + rtol 1e-3 (the card-vs-CPU step tolerance of
chip_smoke.py), and two backward launches equal to the bit.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.models import crf as t_crf
from casualhdrsplat_torch.ops import crf_fused


@pytest.fixture(scope="module")
def ref():
    """The reference's crf module and JAX (imported here, so that the card
    can run this file's `cuda` test without JAX)."""
    import jax
    import jax.numpy as jnp

    from casualhdrsplat_tpu import config as j_config
    from casualhdrsplat_tpu.models import crf as j_crf

    return SimpleNamespace(jax=jax, jnp=jnp, config=j_config, crf=j_crf)


def _raw_params(rng, hidden):
    """Raw CRF parameters with every unit contributing differently."""
    return {
        "unit_k": rng.normal(0.0, 0.5, (3, hidden)).astype(np.float32),
        "unit_c": rng.uniform(0.0, 1.0, (3, hidden)).astype(np.float32),
        "unit_w": rng.normal(-1.0, 1.0, (3, hidden)).astype(np.float32),
        "gain": rng.normal(0.0, 1.0, 3).astype(np.float32),
        "bias": rng.normal(-1.0, 1.0, 3).astype(np.float32),
    }


def _activated(raw, device="cpu"):
    """(k, c, w, g, bias) as crf.apply passes them to the fused function."""
    p = {k: torch.as_tensor(v, device=device) for k, v in raw.items()}
    return (F.softplus(p["unit_k"]) * 20.0, p["unit_c"], F.softplus(p["unit_w"]),
            F.softplus(p["gain"]), p["bias"])


def _images(rng, shape):
    """Exposed radiance over the normalised log range and past it, with
    rows at exactly 0, below 0, near 0 and past exp(log_max)."""
    e = np.exp(rng.uniform(-12.0, 6.0, size=shape)).astype(np.float32)
    e[0] = 0.0
    e[1] = -0.3
    e[2] = 1e-12
    e[3] = np.exp(7.0)
    return e


def _close(got, want, rel, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("hidden", [8, 32])
def test_closed_form_backward_matches_autograd(hidden):
    rng = np.random.default_rng(hidden)
    raw = _raw_params(rng, hidden)
    k, c, w, g, bias = _activated(raw)
    x = torch.as_tensor(np.exp(rng.uniform(-9.0, 3.0, size=(8, 16, 3))).astype(np.float32))
    go = torch.as_tensor(rng.normal(size=x.shape).astype(np.float32))
    cfg = t_config.CRFConfig(hidden=hidden)
    leaves = [t.clone().requires_grad_(True) for t in (x, k, c, w, g, bias)]
    xl, kl, cl, wl, gl, bl = leaves
    # crf._monotone_mlp's chain on the activated parameters
    u = t_crf._norm_log(torch.clamp(xl, min=0.0), cfg).reshape(-1, 3).T
    y = (wl[:, None, :] * torch.sigmoid(kl[:, None, :] * (u[:, :, None] - cl[:, None, :]))).sum(-1)
    y = y + gl[:, None] * u + bl[:, None]
    out = torch.clamp(torch.sigmoid(y) * 1.004 - 0.002, 0.0, 1.0).T.reshape(x.shape)
    auto = torch.autograd.grad((out * go).sum(), leaves)
    closed = crf_fused.monotone_crf_backward_reference(x, go, k, c, w, g, bias,
                                                       cfg.log_min, cfg.log_max)
    for name, a, b in zip(("x", "k", "c", "w", "g", "bias"), auto, closed):
        assert b.shape == a.shape, name
        _close(b.numpy(), a.numpy(), 1e-6, 1e-5, name)
    # the plain forward is crf._monotone_mlp's, bit for bit
    plain = crf_fused.monotone_crf_reference(x, k, c, w, g, bias, cfg.log_min, cfg.log_max)
    mlp = t_crf._monotone_mlp({n: torch.as_tensor(v) for n, v in raw.items()},
                              t_crf._norm_log(torch.clamp(x, min=0.0), cfg))
    torch.testing.assert_close(plain, mlp, rtol=0, atol=0)


@pytest.mark.parametrize("hidden", [8, 32])
def test_apply_and_its_gradients_match_reference(ref, hidden):
    rng = np.random.default_rng(100 + hidden)
    raw = _raw_params(rng, hidden)
    e = _images(rng, (40, 5, 3))
    weights = rng.normal(size=e.shape).astype(np.float32)
    ct, cj = t_config.CRFConfig(hidden=hidden), ref.config.CRFConfig(hidden=hidden)

    pt = {k: torch.tensor(v, requires_grad=True) for k, v in raw.items()}
    et = torch.tensor(e, requires_grad=True)
    out = t_crf.apply(pt, et, ct)
    (out * torch.from_numpy(weights)).sum().backward()

    want = np.asarray(ref.jax.jit(lambda p, x: ref.crf.apply(p, x, cj))(raw, e))
    g_params, g_e = ref.jax.jit(ref.jax.grad(
        lambda p, x: ref.jnp.sum(ref.crf.apply(p, x, cj) * weights), argnums=(0, 1)))(raw, e)
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-6, rtol=0)
    for name in raw:
        _close(pt[name].grad.numpy(), np.asarray(g_params[name]), 1e-6, 1e-4, name)
    g_e = np.asarray(g_e)
    _close(et.grad.numpy(), g_e, 1e-6, 1e-4, "image")
    # the clamp's tie at 0: half the gradient of the side just above it
    # (rtol alone, the values there are the largest of the image)
    np.testing.assert_allclose(et.grad.numpy()[0], g_e[0], rtol=1e-4)
    assert float(np.abs(g_e[1]).max()) == 0.0 == float(et.grad[1].abs().max())


@pytest.mark.parametrize("hidden", [8, 32])
def test_fused_function_checks_its_inputs(hidden):
    rng = np.random.default_rng(hidden)
    params = _activated(_raw_params(rng, hidden))
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match=r"\[\.\.\., 3\]"):
        crf_fused.monotone_crf(torch.zeros(4, 2), *params, -10.0, 4.0)
    with pytest.raises(ValueError, match="parameter w"):
        crf_fused.monotone_crf(x, *params[:2], params[2][:2], *params[3:], -10.0, 4.0)
    with pytest.raises(ValueError, match="up to 64 units"):
        big = _activated(_raw_params(rng, 65))
        crf_fused.monotone_crf(x, *big, -10.0, 4.0)
    # on the CPU no kernel launches
    before = crf_fused.FWD_KERNEL.launches, crf_fused.BWD_KERNEL.launches
    xr = torch.rand(4, 3, requires_grad=True)
    crf_fused.monotone_crf(xr, *params, -10.0, 4.0).sum().backward()
    assert (crf_fused.FWD_KERNEL.launches, crf_fused.BWD_KERNEL.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [8, 32])
def test_kernel_matches_plain_on_the_card(hidden):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7 + hidden)
    params = _activated(_raw_params(rng, hidden), dev)
    # four views of 96x97: a pixel count that leaves a ragged last block
    x = torch.as_tensor(_images(rng, (4, 96, 97, 3)), device=dev)
    go = torch.as_tensor(rng.normal(size=x.shape).astype(np.float32), device=dev)
    flat = x.reshape(-1, 3)
    out = crf_fused._forward_cuda(flat, *params, -10.0, 14.0).reshape(x.shape)
    plain = crf_fused.monotone_crf_reference(x, *params, -10.0, 4.0)
    torch.testing.assert_close(out, plain, atol=1e-5, rtol=0)
    got = crf_fused._backward_cuda(flat, go.reshape(-1, 3), *params, -10.0, 14.0)
    again = crf_fused._backward_cuda(flat, go.reshape(-1, 3), *params, -10.0, 14.0)
    want = crf_fused.monotone_crf_backward_reference(x, go, *params, -10.0, 4.0)
    for name, a, b, w in zip(("x", "k", "c", "w", "g", "bias"), got, again, want):
        assert torch.equal(a, b), f"{name}: two launches differ in their bits"
        scale = float(w.abs().max())
        torch.testing.assert_close(a.reshape(w.shape), w, atol=1e-4 * scale, rtol=1e-3,
                                   msg=name)
    # through crf.apply's autograd: the kernels, counted once each
    before = crf_fused.FWD_KERNEL.launches, crf_fused.BWD_KERNEL.launches
    xr = x.clone().requires_grad_(True)
    crf_fused.monotone_crf(xr, *params, -10.0, 4.0).sum().backward()
    assert (crf_fused.FWD_KERNEL.launches - before[0],
            crf_fused.BWD_KERNEL.launches - before[1]) == (1, 1)
