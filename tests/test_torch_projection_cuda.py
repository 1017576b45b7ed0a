"""Kernel P1 (csrc/projection_fwd.cu, csrc/projection_bwd.cu, launched by
ops/projection_fused.py) held against the plain chain it replaces, on the
card, at a training cell's size: `benchmark/scene.py`'s recipe (131,072
Gaussians of the ladder4-full configuration's resumed state, 8 virtual
views of a frame on the video's spline, or one served orbit pose), with
dead slots and Gaussians behind the camera, at the near plane and off the
screen planted among them.  Marked `cuda`: without a card the fixture
skips every test here.

Run on the card with `python -m pytest tests/test_torch_projection_cuda.py
-m cuda --noconftest`.

- Forward: equal to the chain's outputs bit for bit (payload, means2d,
  depths, radii, valid), every case.
- Backward: against autograd of the chain, per leaf ||g - g_chain|| /
  ||g_chain|| <= 2e-5.  The kernel chains the same derivatives in another
  order (and sums the 8 views, and the pose gradient over 131,072
  Gaussians, in its own fixed order), so the two differ by float32
  rounding: ~1e-7 per operation over chains of ~100 operations, ~1e-6
  measured on the CPU build of the same arithmetic
  (tests/test_torch_projection_fused.py).
- The same bits from run to run, inside a CUDA graph, and for every subset
  of the inputs that asks for a gradient; an isotropic Gaussian's rotation
  gets autograd's exact zero.
- ATen's reductions over a last dimension of 3 and 4 in the order
  csrc/projection.cuh writes down, over millions of inputs.
"""

import json
from pathlib import Path

import pytest
import torch

from casualhdrsplat_torch.geometry import lie
from casualhdrsplat_torch.models import gaussians as gauss_mod
from casualhdrsplat_torch.ops import projection_fused as pf

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent
GRAD_RTOL = 2e-5
LEAVES = ("means", "quats", "log_scales", "opacity_logit", "sh_dc", "sh_rest")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def make_inputs(device, seed: int = 20261018, planted: bool = True):
    """The ladder4-full cell's resumed store and camera, 8 virtual views of
    frame 3 and one served orbit pose: (store, step views [8, 4, 4], served
    view [1, 4, 4], (fx, fy, cx, cy) float32 tensors, width, height)."""
    from benchmark import scene
    from benchmark.reference import geometry as geo
    from benchmark.reference import render as ref

    spec = json.loads((ROOT / "benchmark/configs/ladder4-full.json").read_text())
    model, assumed = spec["config"]["model"], spec["assumed"]
    gen = torch.Generator(device=device).manual_seed(seed)
    video = scene.make_video(gen, assumed["scene"], device, render=False)
    params, _, _ = scene.make_state(gen, video, model, assumed["state"], device)
    store = params["gaussians"]
    poses = torch.as_tensor(video.viewmats, device=device)
    rs = ref.make_scene(poses, video.timestamps, video.cam)
    times = geo.virtual_times(rs.timestamps[3], video.exposures[3], 8)
    step = geo.cubic_spline(rs.base_knots, rs.knot_t0, rs.knot_dt, times).contiguous()
    served = geo.orbit_viewmat(0.05, assumed["scene"]["radius"], 0.7, device)[None]
    fx, fy, cx, cy, width, height = video.cam
    if planted:
        # dead slots; and, seen from the step's first view, Gaussians behind
        # the camera, at the near plane and off the screen
        n = store["means"].shape[0]
        store["alive"][:256] = False
        c2w = lie.se3_inverse(step[0])
        u = torch.rand((768, 3), generator=gen, device=device) * 2.0 - 1.0
        local = torch.empty_like(u)
        local[:256] = torch.stack([u[:256, 0], u[:256, 1], -0.5 + 0.4 * u[:256, 2]], -1)
        local[256:512] = torch.stack([0.01 * u[256:512, 0], 0.01 * u[256:512, 1],
                                      0.05 + 1e-3 * u[256:512, 2]], -1)
        z = 2.0 + u[512:, 2]
        local[512:] = torch.stack([(0.7 + 0.3 * u[512:, 0]) * 2.0 * z,
                                   u[512:, 1] * 1.5 * z, z], -1)
        world = local @ c2w[:3, :3].T + c2w[:3, 3]
        store["means"][n - 768:] = world
    cam = tuple(torch.tensor(v, dtype=torch.float32, device=device) for v in (fx, fy, cx, cy))
    return store, step, served, cam, int(width), int(height)


@pytest.fixture(scope="module")
def inputs(cuda):
    return make_inputs(cuda)


# (views, SH degree or "given", one SH centre shared by the views, antialias, offset)
CASES = {
    "step": ("step", 3, False, False, True),
    "step_deg0": ("step", 0, False, False, True),
    "step_deg1": ("step", 1, False, False, True),
    "step_deg2": ("step", 2, False, False, True),
    "step_antialias": ("step", 3, False, True, True),
    "step_shared": ("step", 3, True, False, True),
    "step_no_offset": ("step", 3, False, False, False),
    "served": ("served", 3, False, False, False),
    "served_antialias": ("served", 2, False, True, False),
    "served_depth": ("served", "given", False, False, False),
    "step_given": ("step", "given", False, False, True),
}


def run_case(inputs, case, chain: bool, grads=LEAVES + ("viewmats", "offset", "colors"),
             seed: int = 7):
    """One case's forward (and, given `grads`, its backward through a fixed
    random weighting of the payload): (payload, means2d, depths, radii,
    valid, {name: gradient})."""
    store, step, served, cam, width, height = inputs
    which, deg, shared, antialias, with_offset = CASES[case]
    vm0 = step if which == "step" else served
    g = torch.Generator(device=vm0.device).manual_seed(seed)
    n, v = store["means"].shape[0], vm0.shape[0]
    leaves = {k: (t.detach().clone().requires_grad_(k in grads) if t.is_floating_point()
                  else t) for k, t in store.items()}
    vm = vm0.detach().clone().requires_grad_("viewmats" in grads)
    offset = (torch.zeros((n, 2), device=vm.device, requires_grad="offset" in grads)
              if with_offset else None)
    colors = None
    if deg == "given":
        colors = (torch.rand((1, n, 3), generator=g, device=vm.device) * 2.0).requires_grad_(
            "colors" in grads)
        deg = 0
    c2w = lie.se3_inverse(vm)
    cams = c2w[v // 2] if shared else c2w
    fn = gauss_mod.project_chain if chain else gauss_mod.project
    payload, projs = fn(leaves, vm, cams, deg, *cam, width, height, 0.05, antialias, colors,
                        offset)
    out = {}
    wanted = {**{k: leaves[k] for k in LEAVES}, "viewmats": vm, "offset": offset,
              "colors": colors}
    wanted = {k: t for k, t in wanted.items() if t is not None and t.requires_grad}
    if wanted:
        w = torch.randn(payload.shape, generator=g, device=vm.device)
        found = torch.autograd.grad((payload * w).sum(), list(wanted.values()),
                                    allow_unused=True)
        out = {k: (torch.zeros_like(t) if d is None else d)
               for (k, t), d in zip(wanted.items(), found)}
    return (payload.detach(), projs.means2d.detach(), projs.depths.detach(),
            projs.radii.detach(), projs.valid.detach(), out)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_equals_the_chain_bit_for_bit(inputs, case):
    with torch.no_grad():
        got = run_case(inputs, case, chain=False, grads=())
        want = run_case(inputs, case, chain=True, grads=())
    for name, a, b in zip(("payload", "means2d", "depths", "radii", "valid"), got[:5], want[:5]):
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            detail = f", {_ulps(a, b)} ulps at most" if a.is_floating_point() else ""
            if name == "payload":
                cols = sorted(set((a != b).nonzero()[:, -1].tolist()))
                detail += f", columns {cols}"
            raise AssertionError(f"{case}: {name} differs in {bad} elements{detail}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_against_autograd_of_the_chain(inputs, case):
    got = run_case(inputs, case, chain=False)[5]
    want = run_case(inputs, case, chain=True)[5]
    assert got.keys() == want.keys()
    for k in want:
        scale = float(want[k].norm())
        gap = float((got[k] - want[k]).norm()) / max(scale, 1e-30)
        assert torch.isfinite(got[k]).all(), (case, k)
        assert gap <= GRAD_RTOL or scale == 0.0 and float(got[k].abs().max()) == 0.0, \
            f"{case}: d {k} relative gap {gap:.3g}"


def test_the_same_bits_from_run_to_run(inputs):
    first = run_case(inputs, "step", chain=False)
    again = run_case(inputs, "step", chain=False)
    for a, b in zip(first[:5], again[:5]):
        assert torch.equal(a, b)
    for k in first[5]:
        assert torch.equal(first[5][k], again[5][k]), k


@pytest.mark.parametrize("wanted", [("viewmats",), ("offset",), LEAVES, ("colors",),
                                    ("means", "viewmats")])
def test_each_subset_of_gradients(inputs, wanted):
    """The pose aligners ask for the pose alone, the trainer for all; the
    kernel writes only what is asked, with the bits of the full call."""
    case = "step_given" if wanted == ("colors",) else "step"
    full = run_case(inputs, case, chain=False)[5]
    part = run_case(inputs, case, chain=False, grads=wanted)[5]
    assert set(part) == set(wanted)
    for k in wanted:
        assert torch.equal(part[k], full[k]), k


def test_isotropic_gaussians_get_no_rotation_gradient(inputs):
    """A fresh store's slots (identity quaternion, equal scales): autograd's
    chain gives their quaternions an exact zero gradient, and so does P1."""
    store, step, served, cam, width, height = inputs
    iso = {k: t.clone() for k, t in store.items()}
    iso["quats"][:4096] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=step.device)
    iso["log_scales"][:4096] = iso["log_scales"][:4096, :1]
    got = run_case((iso, step, served, cam, width, height), "step", chain=False)[5]["quats"]
    want = run_case((iso, step, served, cam, width, height), "step", chain=True)[5]["quats"]
    assert float(want[:4096].abs().max()) == 0.0
    assert float(got[:4096].abs().max()) == 0.0


def test_inside_a_cuda_graph(inputs, cuda):
    """The forward and the backward captured and replayed give the eager
    calls' bits."""
    store, step, served, cam, width, height = inputs
    leaves = {k: (t.detach().clone().requires_grad_(True) if t.is_floating_point() else t)
              for k, t in store.items()}
    vm = step.detach().clone().requires_grad_(True)
    w = torch.randn((8, store["means"].shape[0] + 1, 16), device=cuda)

    def body():
        payload, _ = gauss_mod.project(leaves, vm, lie.se3_inverse(vm), 3, *cam, width,
                                       height)
        return torch.autograd.grad((payload * w).sum(), [leaves["means"], leaves["sh_rest"], vm])

    eager = body()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = body()
    f0, b0 = pf.FWD_KERNEL.launches, pf.BWD_KERNEL.launches
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)
    assert (pf.FWD_KERNEL.launches, pf.BWD_KERNEL.launches) == (f0, b0)  # counted by calls


def test_launch_counters(inputs):
    f0, b0 = pf.FWD_KERNEL.launches, pf.BWD_KERNEL.launches
    run_case(inputs, "served", chain=False)
    assert (pf.FWD_KERNEL.launches - f0, pf.BWD_KERNEL.launches - b0) == (1, 1)
    with torch.no_grad():
        run_case(inputs, "step", chain=False, grads=())
    assert (pf.FWD_KERNEL.launches - f0, pf.BWD_KERNEL.launches - b0) == (2, 1)


def test_atens_small_reductions_run_in_the_order_the_kernel_takes(cuda):
    """csrc/projection.cuh's sum3, norm3 and norm4, written as elementwise
    torch operations (each rounded once), against torch's `.sum(-1)` and
    `torch.linalg.norm` at the shapes of the chain."""
    g = torch.Generator(device=cuda).manual_seed(3)
    n = 1 << 20
    means = torch.randn((n, 3), generator=g, device=cuda)
    vm = torch.randn((8, 4, 4), generator=g, device=cuda)
    prod = means[:, None, :] * vm[..., None, :3, :3]  # [8, n, 3, 3], the chain's product
    p = prod.unbind(-1)
    assert torch.equal(prod.sum(-1), (p[0] + p[2]) + p[1])
    q = torch.randn((4 * n, 4), generator=g, device=cuda) * torch.rand(
        (4 * n, 1), generator=g, device=cuda) * 10.0
    s = (q * q).unbind(-1)
    want = torch.sqrt((s[0] + s[2]) + (s[1] + s[3]))
    assert torch.equal(torch.linalg.norm(q, dim=-1, keepdim=True)[:, 0], want)
    d = means - vm[:, None, :3, 3]  # [8, n, 3], the view directions
    s = (d * d).unbind(-1)
    want = torch.sqrt((s[0] + s[2]) + s[1])
    assert torch.equal(torch.linalg.norm(d, dim=-1, keepdim=True)[..., 0], want)
    x = torch.randn((n,), generator=g, device=cuda) * 8.0
    assert torch.equal(torch.sigmoid(x), 1.0 / (1.0 + torch.exp(-x)))
    # what a broken order would show: the other association differs somewhere
    assert not torch.equal(prod.sum(-1), (p[0] + p[1]) + p[2])
