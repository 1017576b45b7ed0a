"""The projection layer's entry points (models/gaussians.py `project`,
ops/projection_fused.py) on the CPU, and kernel P1's arithmetic built for
the host.

- On CPU tensors `project` is the plain chain the callers ran before it:
  `activate`, `colors_for_view`, `project_gaussians`, the offset,
  `cull_invisible`, `build_payload`; its outputs and their gradients equal
  the chain's written out here, exactly.
- csrc/projection.cuh, the arithmetic of both kernels, compiled for the
  host (tests/projection_host.cpp, the system's C++ compiler, no FMA
  contraction) over a grid of SH degrees, shared and given colors,
  antialias, offsets and view counts: radii and valid flags equal the
  chain's; each payload column within 1e-5 of its largest magnitude (1.3e-6
  measured: the CPU's ATen rounds its exp, its vectorised sums and its
  3-element reductions otherwise than the card's, whose bits the kernel
  matches, tests/test_torch_projection_cuda.py);
  every gradient within 2e-5 of autograd's by relative norm (another order
  of the same float32 products and sums: ~1e-6 measured, the largest
  8e-6 where a mean's SH and projection terms cancel).
- An isotropic Gaussian with the identity quaternion (every slot of a
  fresh store) gets an exactly zero rotation gradient, as from autograd.
- P1's CUDA-only entry refuses CPU tensors.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from casualhdrsplat_torch.geometry import lie
from casualhdrsplat_torch.models import gaussians as gauss_mod
from casualhdrsplat_torch.ops import binning
from casualhdrsplat_torch.ops import projection_fused as pf
from casualhdrsplat_torch.ops.projection import cull_invisible, project_gaussians

ROOT = Path(__file__).resolve().parent.parent
LEAVES = ("means", "quats", "log_scales", "opacity_logit", "sh_dc", "sh_rest")
PAYLOAD_RTOL = 1e-5
GRAD_RTOL = 2e-5

# (views, SH degree or "given", one SH centre shared by the views, antialias, offset)
CASES = {
    "deg0": (3, 0, False, False, True),
    "deg1": (3, 1, False, False, True),
    "deg2": (3, 2, False, False, True),
    "deg3": (3, 3, False, False, True),
    "shared": (3, 3, True, False, True),
    "antialias": (3, 3, False, True, True),
    "given": (3, "given", False, False, True),
    "given_shared": (3, "given", True, False, False),
    "one_view": (1, 3, False, False, False),
}


def _inputs(case, seed):
    """A small store with dead slots and Gaussians behind the cameras, the
    views, the camera, and the case's colors and offset, every floating
    input a leaf that wants a gradient."""
    v, deg, shared, antialias, with_offset = CASES[case]
    g = torch.Generator().manual_seed(seed)
    n = 300

    def r(*shape):
        return torch.randn(shape, generator=g)

    store = {"means": r(n, 3) * 1.5, "quats": r(n, 4), "log_scales": r(n, 3) * 0.5 - 2.5,
             "opacity_logit": r(n), "sh_dc": r(n, 1, 3), "sh_rest": r(n, 15, 3) * 0.3,
             "alive": torch.rand(n, generator=g) > 0.1}
    store["means"][:5, 2] = -4.0  # behind every camera
    base = torch.eye(4)
    base[2, 3] = 5.0
    viewmats = lie.mat_mul(lie.se3_exp(r(v, 6) * 0.1), base.expand(v, 4, 4))
    leaves = {k: t.requires_grad_(True) if t.is_floating_point() else t
              for k, t in store.items()}
    viewmats.requires_grad_(True)
    offset = torch.zeros((n, 2), requires_grad=True) if with_offset else None
    colors = None
    if deg == "given":
        colors = torch.rand((1 if shared else v, n, 3), generator=g).requires_grad_(True)
    cam = (torch.tensor(60.0), torch.tensor(62.0), torch.tensor(40.0), torch.tensor(30.0))
    return leaves, viewmats, cam, colors, offset, (0 if deg == "given" else deg), shared, antialias


def _grads(payload, ins, seed):
    w = torch.randn(payload.shape, generator=torch.Generator().manual_seed(seed + 1))
    return torch.autograd.grad((payload * w).sum(), ins, allow_unused=True, retain_graph=True), w


@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_project_is_the_chain(case):
    leaves, vm, cam, colors, offset, deg, shared, antialias = _inputs(case, 11)
    c2w = lie.se3_inverse(vm)
    cams = c2w[vm.shape[0] // 2] if shared else c2w
    payload, projs = gauss_mod.project(leaves, vm, cams, deg, *cam, 80, 64, 0.05, antialias,
                                       colors, offset)
    # the chain as render_frame and rasterize wrote it
    act = gauss_mod.activate(leaves)
    rgb = colors if colors is not None else gauss_mod.colors_for_view(act, cams, deg)
    p = project_gaussians(act.means3d, act.quats, act.scales, vm, *cam, 80, 64,
                          near_plane=0.05, antialias=antialias)
    if offset is not None:
        p = p._replace(means2d=p.means2d + offset)
    p = cull_invisible(p, act.opacities)
    want = binning.build_payload(p, rgb.expand((vm.shape[0],) + rgb.shape[-2:]), act.opacities)
    for a, b in ((payload, want), (projs.depths, p.depths), (projs.radii, p.radii),
                 (projs.valid, p.valid), (projs.means2d, p.means2d)):
        assert torch.equal(a, b)
    ins = [leaves[k] for k in LEAVES] + [vm] + [t for t in (offset, colors) if t is not None]
    got, _ = _grads(payload, ins, 11)
    ref, _ = _grads(want, ins, 11)
    for a, b in zip(got, ref):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no C++ compiler to build the kernel's arithmetic for the host")
    lib = tmp_path_factory.mktemp("p1") / "projection_host.so"
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    f"-I{ROOT / 'casualhdrsplat_torch' / 'csrc'}", "-o", str(lib),
                    str(ROOT / "tests" / "projection_host.cpp")], check=True)
    so = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.host_projection_fwd.argtypes = [p] * 20 + [i] * 7 + [f] * 3
    so.host_projection_bwd.argtypes = [p] * 26 + [i] * 7 + [f] * 3
    return so


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_arithmetic_on_the_host(host, case):
    leaves, vm, cam, colors, offset, deg, shared, antialias = _inputs(case, 5)
    n, v = leaves["means"].shape[0], vm.shape[0]
    c2w = lie.se3_inverse(vm)
    cams = c2w[v // 2] if shared else c2w
    payload, projs = gauss_mod.project_chain(leaves, vm, cams, deg, *cam, 80, 64, 0.05,
                                             antialias, colors, offset)
    ins = [leaves[k] for k in LEAVES] + [vm] + [t for t in (offset, colors) if t is not None]
    ref, w = _grads(payload, ins, 5)

    s = {k: t.detach().contiguous() for k, t in leaves.items()}
    given = colors is not None
    col = colors.detach().contiguous() if given else None
    c2w_in = None if given else cams.detach().reshape(-1, 4, 4).contiguous()
    off = offset.detach().contiguous() if offset is not None else None
    vmd = vm.detach().contiguous()
    args = [_ptr(s["means"]), _ptr(s["quats"]), _ptr(s["log_scales"]), _ptr(s["opacity_logit"]),
            None if given else _ptr(s["sh_dc"]), None if given else _ptr(s["sh_rest"]),
            _ptr(col), _ptr(vmd), _ptr(c2w_in), _ptr(off), _ptr(s["alive"]),
            *[_ptr(c) for c in cam]]
    tail = [n, v, (col if given else c2w_in).shape[0], 15, -1 if given else deg, 1,
            int(antialias), 0.05, 80.0, 64.0]
    out = torch.empty_like(payload)
    means2d, depths, radii = torch.empty((v, n, 2)), torch.empty((v, n)), torch.empty((v, n))
    valid = torch.empty((v, n), dtype=torch.bool)
    host.host_projection_fwd(*args, _ptr(out), _ptr(means2d), _ptr(depths), _ptr(radii),
                             _ptr(valid), *tail)
    assert torch.equal(radii, projs.radii) and torch.equal(valid, projs.valid)
    assert torch.equal(means2d, out[:, :-1, :2])
    torch.testing.assert_close(depths, projs.depths, rtol=1e-6, atol=1e-6)
    want = payload.detach()
    gap = (out - want).abs().amax(dim=(0, 1)) / want.abs().amax(dim=(0, 1)).clamp(min=1e-30)
    assert float(gap.max()) <= PAYLOAD_RTOL

    gs = [torch.zeros_like(s[k]) for k in LEAVES]
    g_col = torch.zeros_like(col) if given else None
    g_off = torch.zeros_like(off) if off is not None else None
    g_vm = torch.zeros((v, 4, 4))
    g_c2w = torch.zeros((tail[2], 4, 4))
    host.host_projection_bwd(*args, _ptr(w.contiguous()), *[_ptr(t) for t in gs], _ptr(g_col),
                             _ptr(g_vm), _ptr(g_c2w), _ptr(g_off), *tail)
    if not given:  # the camera centres' gradient reaches the matrices through se3_inverse
        (through,) = torch.autograd.grad(cams, vm, g_c2w.reshape(cams.shape))
        g_vm = g_vm + through
    mine = gs + [g_vm] + [t for t in (g_off, g_col) if t is not None]
    names = list(LEAVES) + ["viewmats"] + [k for k, t in (("offset", g_off), ("colors", g_col))
                                           if t is not None]
    for name, a, b in zip(names, mine, ref):
        if b is None:  # sh_dc, sh_rest with colors given
            assert float(a.abs().max()) == 0.0, name
            continue
        gap = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        assert gap <= GRAD_RTOL or float(b.norm()) == 0.0 and float(a.norm()) == 0.0, \
            f"{case}: d {name} relative gap {gap:.3g}"


def test_isotropic_gaussians_get_no_rotation_gradient(host):
    """A fresh store's Gaussians (identity quaternion, equal scales) have a
    rotation the image cannot see: autograd's chain gives their quaternions
    an exact zero gradient, and so must the kernel's arithmetic (noise
    there would become whole Adam steps at eps = 1e-15)."""
    leaves, vm, cam, _, offset, deg, _, _ = _inputs("deg3", 9)
    with torch.no_grad():
        leaves["quats"][:100] = torch.tensor([1.0, 0.0, 0.0, 0.0])
        leaves["log_scales"][:100] = leaves["log_scales"][:100, :1]
    c2w = lie.se3_inverse(vm)
    payload, _ = gauss_mod.project_chain(leaves, vm, c2w, deg, *cam, 80, 64, 0.05, False, None,
                                         offset)
    (ref,), w = _grads(payload, [leaves["quats"]], 9)
    assert float(ref[:100].abs().max()) == 0.0
    s = {k: t.detach().contiguous() for k, t in leaves.items()}
    n, v = s["means"].shape[0], vm.shape[0]
    c2w_in, vmd = c2w.detach().contiguous(), vm.detach().contiguous()
    g_quats = torch.full_like(s["quats"], float("nan"))
    g_vm, g_c2w = torch.zeros((v, 4, 4)), torch.zeros((v, 4, 4))
    host.host_projection_bwd(
        _ptr(s["means"]), _ptr(s["quats"]), _ptr(s["log_scales"]), _ptr(s["opacity_logit"]),
        _ptr(s["sh_dc"]), _ptr(s["sh_rest"]), None, _ptr(vmd), _ptr(c2w_in),
        _ptr(offset.detach()), _ptr(s["alive"]), *[_ptr(c) for c in cam],
        _ptr(w.contiguous()), None, _ptr(g_quats), None, None, None, None, None, _ptr(g_vm),
        _ptr(g_c2w), None, n, v, v, 15, deg, 1, 0, 0.05, 80.0, 64.0)
    assert float(g_quats[:100].abs().max()) == 0.0
    gap = float((g_quats - ref).norm() / ref.norm())
    assert gap <= GRAD_RTOL


def test_the_cuda_entry_refuses_cpu_tensors():
    leaves, vm, cam, _, _, _, _, _ = _inputs("deg3", 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pf.project_leaves(leaves["means"], leaves["quats"], leaves["log_scales"],
                          leaves["opacity_logit"], leaves["alive"], leaves["sh_dc"],
                          leaves["sh_rest"], 3, lie.se3_inverse(vm), vm, *cam, 80, 64)


@pytest.mark.parametrize("case", ["one_view", "antialias"])
def test_project_geometry_is_projects_geometry(case):
    """The start-up checks' projection: `project`'s means2d, depths, radii
    and valid flags, whatever the colours."""
    leaves, vm, cam, _, _, deg, _, antialias = _inputs(case, 5)
    with torch.no_grad():
        _, want = gauss_mod.project(leaves, vm, lie.se3_inverse(vm), deg, *cam, 80, 64, 0.05,
                                    antialias)
        got = gauss_mod.project_geometry(leaves, vm, *cam, 80, 64, near_plane=0.05,
                                         antialias=antialias)
    for name in ("means2d", "depths", "radii", "valid"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
