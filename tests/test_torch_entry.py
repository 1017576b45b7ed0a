"""Port parity: casualhdrsplat_torch.entry against the reference's
`__graft_entry__.entry()`, under `jax.jit`; the port runs on CPU tensors
(the plain versions of its kernels).

`entry()`'s backend "auto" means the packed kernel B1 on the reference's
TPU, but its XLA dense compositor on a CPU, whose 64-slot tile lists drop
224 contributions of this scene (ROADMAP.md §C).  The port's "auto" is the
packed path on any device.  So the frame is compared with the reference's
entry function on the packed path, `_tiny_setup(backend="pallas")` (kernel
B1 in interpret mode), which is what `entry()` runs on its chip.

The port's CRF init draws its jitter from a torch.Generator, not
jax.random (ROADMAP.md §C): the reference's parameters are carried across
with `convert.params_from_jax` for the image comparison, and the port's
own init is held to the reference's init separately.

Tolerances: blurred frame atol 1e-5 (float32 through the pose spline,
projection, compositor and CRF); the init's CRF response curve 1e-3, as
crf.create's parity test; the rest of the init equal or within float32 rounding."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch import entry as t_entry
from casualhdrsplat_torch.models import crf as t_crf
from casualhdrsplat_tpu.models import image_formation as j_imf
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def entries():
    fn_j, args_j = __graft_entry__.entry()
    fn_t, args_t = t_entry.entry(device="cpu")
    return fn_j, args_j, fn_t, args_t


def test_forward_matches_reference(entries):
    fn_j, args_j, fn_t, args_t = entries
    _, cfg, scene, params = __graft_entry__._tiny_setup(backend="pallas")
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(args_j[0])):
        np.testing.assert_array_equal(a, b)  # the same parameters as entry()'s
    want = np.asarray(jax.jit(
        lambda p, f: j_imf.render_frame(p, scene, f, cfg).blurred_ldr)(*args_j))
    np_params = jax.tree_util.tree_map(np.asarray, args_j[0])
    with torch.no_grad():
        got = fn_t(convert.params_from_jax(np_params, device="cpu"), int(args_j[1])).numpy()
    assert got.shape == want.shape == (32, 32, 3)
    assert want.max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # entry() itself on a CPU: the dense compositor's drops, nothing else
    dense = np.asarray(jax.jit(fn_j)(*args_j))
    assert np.abs(dense - want).max() > 1e-3


def test_port_init_matches_reference_init(entries):
    _, args_j, fn_t, args_t = entries
    p_t, p_j = args_t[0], jax.tree_util.tree_map(np.asarray, args_j[0])
    assert args_t[1] == int(args_j[1]) == 1
    for k, v in p_t["gaussians"].items():
        np.testing.assert_allclose(v.numpy(), p_j["gaussians"][k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_array_equal(p_t["knot_deltas"].numpy(), p_j["knot_deltas"])
    np.testing.assert_allclose(p_t["log_exposures"].numpy(), p_j["log_exposures"],
                               rtol=1e-6)
    # the CRF: another jitter draw, the same fitted curve (as crf.create's
    # own parity test holds it)
    assert set(p_t["crf"]) == set(p_j["crf"])
    crf_cfg = t_config.CRFConfig(kind="mlp", hidden=8)
    _, curve_t = t_crf.response_curve(p_t["crf"], crf_cfg, device="cpu")
    _, curve_j = t_crf.response_curve(convert.params_from_jax(p_j, device="cpu")["crf"],
                                      crf_cfg, device="cpu")
    np.testing.assert_allclose(curve_t, curve_j, atol=1e-3)
    with torch.no_grad():
        out = fn_t(*args_t)
    assert out.shape == (32, 32, 3) and bool(torch.isfinite(out).all())
    assert 0.0 <= float(out.min()) and float(out.max()) <= 1.0


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    # the fixture renders on the default device, which needs the card
    with pytest.raises((RuntimeError, AssertionError)):
        t_entry.entry()
