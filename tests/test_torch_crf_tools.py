"""The measuring tools around kernel T1, on the CPU: utils/sass.py (a SASS
listing's kernels, the per-element instruction mix of a hot loop with its
nested loops weighted, the MUFU and issue floors) and
casualhdrsplat_torch/crf_compare.py's clip ties (elements whose output
before the clip lies within CLIP_TIE of 0 or 1, in float64) and its
per-group backward comparison."""

import numpy as np
import pytest
import torch

from casualhdrsplat_torch import crf_compare
from casualhdrsplat_torch.ops import crf_fused
from casualhdrsplat_torch.utils import sass

# cuobjdump -sass's layout: a kernel, an outer loop (0x0020-0x00a0) holding
# an inner one (0x0040-0x0060), a divergence branch and a forward branch
LISTING = """
	code for sm_90a
		Function : _Z6kernelILi32EEvPf
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
                                                                         /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                    /* 0x0000000000007919 */
        /*0020*/                   LDS.128 R4, [R2] ;                    /* 0x0000000002047984 */
        /*0030*/                   FADD R5, R4, -R5 ;                    /* 0x8000000504057221 */
        /*0040*/                   MUFU.EX2 R6, R5 ;                     /* 0x0000000500067308 */
        /*0050*/                   FFMA R7, R6, R6, R7 ;                 /* 0x0000000606077223 */
        /*0060*/              @!P0 BRA 0x40 ;                            /* 0xfffffffc00008947 */
        /*0070*/                   BRA.DIV UR4, 0x200 ;                  /* 0x0000000604007947 */
        /*0080*/                   SHFL.BFLY PT, R8, R7, 0x1, 0x1f ;     /* 0x0c201f0007087f89 */
        /*0090*/                   MUFU.RCP R9, R8 ;                     /* 0x0000000800097308 */
        /*00a0*/               @P1 BRA 0x20 ;                            /* 0xffffff7000001947 */
        /*00b0*/                   BRA 0x10 ;                            /* 0xfffffff000007947 */
        /*00c0*/                   EXIT ;                                /* 0x000000000000794d */
		Function : _Z4flatPf
        /*0000*/                   FMUL R1, R2, R3 ;                     /* 0x0000000302017220 */
        /*0010*/                   MUFU.LG2 R1, R1 ;                     /* 0x0000000100017308 */
        /*0020*/                   EXIT ;                                /* 0x000000000000794d */
"""


def test_sass_listing_and_mix():
    funcs = sass.parse(LISTING)
    assert sorted(funcs) == ["_Z4flatPf", "_Z6kernelILi32EEvPf"]
    kernel = sass.find(funcs, "kernelILi32E")
    assert len(kernel) == 13 and kernel[6] == (0x60, True, "BRA", "0x40")
    # the widest predicated branch back is the hot loop; the unpredicated
    # BRA 0x10 and BRA.DIV are not loops; the inner loop's 3 instructions
    # count 4 times, over 2 elements a pass
    mix = sass.element_mix(kernel, elements_per_pass=2, inner_trips=4)
    assert mix == {"MUFU.EX2": 2.0, "MUFU.RCP": 0.5, "MUFU.LG2": 0.0, "FFMA": 2.0,
                   "FMUL": 0.0, "FADD": 0.5, "SHFL": 0.5, "LDS": 0.5,
                   "all": (6 + 3 * 4) / 2}
    flat = sass.element_mix(sass.find(funcs, "flat"), elements_per_pass=0.5)
    assert flat["MUFU.LG2"] == 2.0 and flat["FMUL"] == 2.0 and flat["all"] == 6.0
    with pytest.raises(KeyError):
        sass.find(funcs, "_Z")
    floors = sass.floors_ms(mix, elements=1_000_000, sms=2, clock_hz=1e9)
    assert floors["mufu_floor_ms"] == pytest.approx(2.5e6 / (16 * 2 * 1e9) * 1e3)
    assert floors["issue_floor_ms"] == pytest.approx(9e6 / (128 * 2 * 1e9) * 1e3)


def _params(hidden, seed):
    rng = np.random.default_rng(seed)
    k = torch.as_tensor(20.0 * np.log1p(np.exp(rng.normal(0.0, 0.5, (3, hidden)))),
                        dtype=torch.float32)
    c = torch.as_tensor(rng.uniform(0.0, 1.0, (3, hidden)), dtype=torch.float32)
    w = torch.as_tensor(np.log1p(np.exp(rng.normal(-1.0, 1.0, (3, hidden)))),
                        dtype=torch.float32)
    # crf.create's gain and bias: the curve crosses 0 and reaches 1
    g = torch.as_tensor(rng.uniform(11.0, 13.0, 3), dtype=torch.float32)
    bias = torch.as_tensor(rng.uniform(-11.5, -11.0, 3), dtype=torch.float32)
    return k, c, w, g, bias


def _pre_clip(x, k, c, w, g, bias, log_min, span):
    """The output before the clip, in float64, per element."""
    u = (np.log(np.maximum(x, 0.0) + 1e-8) - log_min) / span
    y = (w[None] / (1.0 + np.exp(-k[None] * (u[..., None] - c[None])))).sum(-1)
    return 1.004 / (1.0 + np.exp(-(y + g * u + bias))) - 0.002


@pytest.mark.parametrize("hidden", [8, 32])
def test_clip_ties_mark_the_clip_bounds_alone(hidden):
    params = _params(hidden, hidden)
    p64 = [p.double().numpy() for p in params]
    log_min, span = -10.0, 14.0
    x = np.exp(np.random.default_rng(1).uniform(-11.0, 5.0, (64, 3)))
    # rows 0 and 1: each channel's input where the output crosses 0, and 1
    # where it reaches it, found by bisection in float64 on log x
    for row, target in ((0, 0.0), (1, 1.0)):
        for ch in range(3):
            lo, hi = -30.0, 30.0
            f = lambda t: _pre_clip(np.full((1, 3), np.exp(t)), *p64, log_min, span)[0, ch]
            if (f(lo) - target) * (f(hi) - target) > 0:
                continue  # the curve never reaches this bound
            for _ in range(200):
                mid = 0.5 * (lo + hi)
                lo, hi = (mid, hi) if (f(mid) - target) * (f(lo) - target) > 0 else (lo, mid)
            x[row, ch] = np.exp(0.5 * (lo + hi))
    xt = torch.as_tensor(x, dtype=torch.float32)
    ties = crf_compare.clip_ties(xt, *params, log_min, span).numpy()
    o = _pre_clip(xt.double().numpy(), *p64, log_min, span)
    want = (np.abs(o) <= crf_compare.CLIP_TIE) | (np.abs(o - 1.0) <= crf_compare.CLIP_TIE)
    np.testing.assert_array_equal(ties, want)
    assert ties[0].any() and not ties[2:].any()


def test_backward_outliers_count_each_group():
    params = _params(8, 3)
    x = torch.exp(torch.linspace(-9.0, 3.0, 48)).reshape(16, 3)
    go = torch.linspace(-1.0, 1.0, 48).reshape(16, 3)
    want = crf_fused.monotone_crf_backward_reference(x, go, *params, -10.0, 4.0)
    same = crf_compare.backward_outliers(want, want)
    assert all(n == 0 and e == 0.0 for n, e in same.values())
    moved = list(want)
    moved[0] = want[0].clone()
    moved[0][3, 1] += 0.5 * float(want[0].abs().max())
    res = crf_compare.backward_outliers(moved, want)
    assert res["x"][0] == 1 and res["x"][1] == pytest.approx(0.5)
    assert all(res[name][0] == 0 for name in ("k", "c", "w", "g", "bias"))
