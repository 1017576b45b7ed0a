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

- a plain NumPy emulation of the card's backward schedule (the grid of
  `_bwd_blocks`, the pixels each block, warp and lane group takes per
  pass, an element's units split over G lanes with the group's
  butterfly sums, every lane's float32 sums over its passes, the warps'
  butterfly, the block's row in warp order, the column sum's 32 strands,
  and `_split_total`'s slices) against `monotone_crf_backward_reference`
  (atol 1e-6 x the group's largest + rtol 1e-4: the same float32 terms
  summed in another order) and against jax.grad of the reference's
  `crf.apply` (the raw parameters' gradients by the chain rule through
  softplus; atol 1e-6 x the largest + rtol 1e-4, as above), hidden 8, 32
  and 64, on a pixel count that leaves every level of the schedule
  ragged.

On the card (marked `cuda`, skipped here; hidden 8, 32 and 64, sizes 0,
1, 64, 256 and 4 x 96 x 97): the kernels against the plain versions,
forward atol 1e-5 (exp2, rcp and the backward's log2 are the approximate
hardware ones, a few ulp each; four units share one reciprocal, the sums
run in another order over up to 64 weighted units), backward every group
within 1e-4 x its largest + rtol 1e-3 (the card-vs-CPU step tolerance of
chip_smoke.py), two backward launches equal to the bit, and one counted
launch each way through autograd (none for an empty image, whose
parameter gradients are zero).
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


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _emulated_backward(x, go, k, c, w, g, bias, log_min, log_max, sms):
    """The card's backward (csrc/crf_mlp_bwd.cu) in NumPy float32, sum by
    sum in the kernel's order: a persistent grid of `_bwd_blocks` blocks
    of 3 channel sets of `_BWD_WARPS_PER_CHANNEL` warps, groups of G lanes
    an element, lane q of a group on units q, q + G, ...  Returns what
    `_backward_cuda` returns, as NumPy arrays."""
    n, h = x.shape[0], k.shape[1]
    hp = crf_fused._padded_hidden(h)
    G = crf_fused._bwd_lanes(hp)
    U, groups, W = hp // G, 32 // G, crf_fused._BWD_WARPS_PER_CHANNEL
    blocks = crf_fused._bwd_blocks(n, hp, sms)
    per_pass = blocks * W * groups
    passes = -(-n // per_pass)
    span = np.float32(log_max - log_min)
    pad = lambda a, v: np.concatenate([a, np.full(passes * per_pass - n, v, np.float32)])
    part = np.zeros((blocks, 3, 3 * hp + 2), np.float32)
    dx = np.zeros((n, 3), np.float32)
    for ch in range(3):
        kp, cp, wp = (np.zeros(hp, np.float32) for _ in range(3))
        kp[:h], cp[:h], wp[:h] = k[ch], c[ch], w[ch]
        # pixel base + group of pass r: [passes, blocks, W, groups]
        xv = pad(x[:, ch], 1.0).reshape(passes, blocks, W, groups)
        gv = pad(go[:, ch], 0.0).reshape(passes, blocks, W, groups)
        ee = np.maximum(xv, np.float32(0)) + np.float32(1e-8)
        u = (np.log(ee) - np.float32(log_min)) / span
        j = np.arange(U)[None, :] * G + np.arange(G)[:, None]  # lane q's units [G, U]
        d = u[..., None, None] - cp[j]
        s = _f32(1.0 / (1.0 + np.exp(-(kp[j] * d))))
        ws = wp[j] * (s - s * s)
        y, dydu = np.zeros(u.shape + (G,), np.float32), np.zeros(u.shape + (G,), np.float32)
        for i in range(U):  # each lane's units in order
            y = y + wp[j[:, i]] * s[..., i]
            dydu = dydu + ws[..., i] * kp[j[:, i]]
        off = 1
        while off < G:  # the group's butterfly: every lane the same bits
            y = y + y[..., np.arange(G) ^ off]
            dydu = dydu + dydu[..., np.arange(G) ^ off]
            off *= 2
        y, dydu = y[..., 0], dydu[..., 0]
        sy = _f32(1.0 / (1.0 + np.exp(-(g[ch] * u + y + bias[ch]))))
        o = sy * np.float32(1.004) - np.float32(0.002)
        dq = np.where((o > 0) & (o < 1), 1.0, np.where((o == 0) | (o == 1), 0.5, 0.0))
        t = _f32(gv * _f32(dq) * np.float32(1.004) * (sy * (np.float32(1) - sy)))
        de = np.where(xv > 0, 1.0, np.where(xv == 0, 0.5, 0.0)).astype(np.float32)
        dx[:, ch] = (t * (dydu + g[ch]) / (ee * span) * de).reshape(-1)[:n]
        # every lane's sums over its passes, in pass order
        acc = np.zeros((3, blocks, W, groups, G, U), np.float32)
        acc_gb = np.zeros((2, blocks, W, groups), np.float32)
        for r in range(passes):
            tr = t[r][..., None, None]
            acc[0] += tr * (ws[r] * d[r])
            acc[1] += tr * ws[r]
            acc[2] += tr * s[r]
            acc_gb[0] += t[r] * u[r]
            acc_gb[1] += t[r]
        off = 1
        while off < groups:  # the warp's butterfly over its groups
            acc = acc + acc[:, :, :, np.arange(groups) ^ off]
            acc_gb = acc_gb + acc_gb[:, :, :, np.arange(groups) ^ off]
            off *= 2
        rows = np.zeros((blocks, W, 3 * hp + 2), np.float32)
        rows[:, :, j.T.reshape(-1)] = acc[0][:, :, 0].transpose(0, 1, 3, 2).reshape(blocks, W, -1)
        rows[:, :, hp + j.T.reshape(-1)] = (
            -kp[j] * acc[1][:, :, 0]).transpose(0, 1, 3, 2).reshape(blocks, W, -1)
        rows[:, :, 2 * hp + j.T.reshape(-1)] = acc[2][:, :, 0].transpose(0, 1, 3, 2).reshape(
            blocks, W, -1)
        rows[:, :, 3 * hp:] = acc_gb[:, :, :, 0].transpose(1, 2, 0)
        part[:, ch] = rows[:, 0]
        for wi in range(1, W):  # the block's warps in order
            part[:, ch] += rows[:, wi]
    part = part.reshape(blocks, -1)
    strands = np.zeros((32, part.shape[1]), np.float32)
    for r in range(blocks):  # strand r % 32 takes rows r, r + 32, ...
        strands[r % 32] += part[r]
    total = strands[0].copy()
    for i in range(1, 32):
        total += strands[i]
    grads = crf_fused._split_total(torch.from_numpy(total.reshape(3, -1)), h, hp)
    return (dx, *(a.numpy() for a in grads))


@pytest.mark.parametrize("hidden", [8, 32, 64])
def test_emulated_card_backward_matches_reference_and_jax(ref, hidden):
    rng = np.random.default_rng(300 + hidden)
    raw = _raw_params(rng, hidden)
    # the grid of a 3-SM card: 3,070 pixels take several passes, the last
    # one ragged in blocks, warps and groups
    sms = 3
    e = _images(rng, (3 * 1021 + 7, 3))
    weights = rng.normal(size=e.shape).astype(np.float32)
    cj = ref.config.CRFConfig(hidden=hidden)
    k, c, w, g, bias = (t.numpy() for t in _activated(raw))
    got = _emulated_backward(e, weights, k, c, w, g, bias, cj.log_min, cj.log_max, sms)
    hp = crf_fused._padded_hidden(hidden)
    n = e.shape[0]
    per_pass = crf_fused._bwd_blocks(n, hp, sms) * crf_fused._BWD_WARPS_PER_CHANNEL * 32 // (
        crf_fused._bwd_lanes(hp))
    assert n % per_pass and n > 2 * per_pass
    want = crf_fused.monotone_crf_backward_reference(
        torch.from_numpy(e), torch.from_numpy(weights), *_activated(raw), cj.log_min,
        cj.log_max)
    for name, a, b in zip(("x", "k", "c", "w", "g", "bias"), got, want):
        assert a.shape == tuple(b.shape), name
        _close(a, b.numpy(), 1e-6, 1e-4, name)
    # and the reference's jax.grad of crf.apply, through softplus
    g_params, g_e = ref.jax.jit(ref.jax.grad(
        lambda p, x: ref.jnp.sum(ref.crf.apply(p, x, cj) * weights), argnums=(0, 1)))(raw, e)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v.astype(np.float64)))
    chained = {"unit_k": got[1] * 20.0 * sig(raw["unit_k"]), "unit_c": got[2],
               "unit_w": got[3] * sig(raw["unit_w"]), "gain": got[4] * sig(raw["gain"]),
               "bias": got[5]}
    for name, v in chained.items():
        _close(v, np.asarray(g_params[name]), 1e-6, 1e-4, name)
    _close(got[0], np.asarray(g_e), 1e-6, 1e-4, "image")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("size", [(0,), (1,), (64,), (256,), (4, 96, 97)],
                         ids=["0", "1", "64", "256", "4x96x97"])
@pytest.mark.parametrize("hidden", [8, 32, 64])
def test_kernel_matches_plain_on_the_card(cuda, hidden, size):
    rng = np.random.default_rng(7 + hidden)
    params = _activated(_raw_params(rng, hidden), cuda)
    shape = size + (3,)
    x = torch.as_tensor(_images(rng, shape) if shape[0] >= 4 else
                        np.exp(rng.uniform(-12.0, 6.0, size=shape)).astype(np.float32),
                        device=cuda)
    go = torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=cuda)
    flat = x.reshape(-1, 3)
    out = crf_fused._forward_cuda(flat, *params, -10.0, 14.0).reshape(x.shape)
    plain = crf_fused.monotone_crf_reference(x, *params, -10.0, 4.0)
    torch.testing.assert_close(out, plain, atol=1e-5, rtol=0)
    got = crf_fused._backward_cuda(flat, go.reshape(-1, 3), *params, -10.0, 14.0)
    again = crf_fused._backward_cuda(flat, go.reshape(-1, 3), *params, -10.0, 14.0)
    want = crf_fused.monotone_crf_backward_reference(x, go, *params, -10.0, 4.0)
    for name, a, b, w in zip(("x", "k", "c", "w", "g", "bias"), got, again, want):
        assert torch.equal(a, b), f"{name}: two launches differ in their bits"
        scale = float(w.abs().max()) if w.numel() else 0.0
        torch.testing.assert_close(a.reshape(w.shape), w, atol=1e-4 * scale, rtol=1e-3,
                                   msg=name)
    # through crf.apply's autograd: the kernels, counted once each (an empty
    # image launches nothing, and its parameter gradients are zero)
    before = crf_fused.FWD_KERNEL.launches, crf_fused.BWD_KERNEL.launches
    xr = x.clone().requires_grad_(True)
    leaves = [p.clone().requires_grad_(True) for p in params]
    crf_fused.monotone_crf(xr, *leaves, -10.0, 4.0).sum().backward()
    launched = 1 if x.numel() else 0
    assert (crf_fused.FWD_KERNEL.launches - before[0],
            crf_fused.BWD_KERNEL.launches - before[1]) == (launched, launched)
    if not x.numel():
        assert all(float(p.grad.abs().max()) == 0.0 for p in leaves)
