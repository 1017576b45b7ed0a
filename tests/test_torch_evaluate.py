"""Port parity for `Trainer.evaluate`: the port's evaluation against the
reference's on one tiny dataset with a hold-out (frames 0 and 2 of 4) and
sharp ground-truth frames, the reference's parameters carried across with
`convert.params_from_jax` (the `trainers` fixture's construction of
tests/test_torch_train_step.py: an MLP CRF, 2 virtual views, the packed
path; the reference's Pallas kernels in interpret mode, the port's plain
versions on CPU tensors).  The reference runs its own jitted programs
(`_eval_render`, `_eval_render_deblurred`, `_eval_render_novel`,
`_metric_vector`) as they are.

Every key of `evaluate()` (blurred fit, deblurred, novel views, the
input's own PSNR) and of `evaluate(indices=[1, 3])`, with these
tolerances: PSNR within 1e-4 dB; SSIM and MS-SSIM within 5e-6: the two
packages' SSIM of the same images agree to 2e-6 (their convolutions sum
taps in another order, ROADMAP §C; tests/test_torch_losses.py holds
MS-SSIM to 1e-5), and here the images differ as well, by the renders'
~1e-6 (measured: 2.3e-6 at most).

Also on the CPU: the graphed path of `evaluate` (each render and its
metric vector one call of a GraphedCall, here a stand-in that calls the
function it would capture) equals the eager path to the bit, makes one
host read per evaluated frame and reads the learned exposures once; a
server's `render_pose` on the same GraphedRenders, started between the
novel view's fill of the exposure buffer and its replay, waits for the
replay and leaves the metrics as they were.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_graphed_descents as descents
from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch.models import image_formation as imf
from casualhdrsplat_torch.train.trainer import Trainer as TorchTrainer
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.data import dataset as j_dataset
from casualhdrsplat_tpu.train.trainer import Trainer as JaxTrainer
from test_torch_train_step import _cfg, _port_dataset
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PSNR_ATOL = 1e-4
SSIM_ATOL = 5e-6


def _eval_cfg(mod):
    cfg = _cfg(mod)
    cfg.data.eval_every = 2  # frames 0 and 2 held out
    return cfg


@pytest.fixture(scope="module")
def trainers():
    """(reference trainer, port trainer) on one dataset with a hold-out and
    sharp frames, from one perturbed parameter set."""
    ds_j = j_dataset.make_synthetic_dataset(seed=3, n_gaussians=96, n_frames=4,
                                            n_virtual=2, size=32)
    assert ds_j.sharp_images is not None
    tj = JaxTrainer(_eval_cfg(j_config), ds_j)
    rng = np.random.default_rng(11)
    np_params = jax.tree_util.tree_map(lambda a: np.array(a), tj.params)
    g = np_params["gaussians"]
    g["sh_rest"] = (rng.normal(size=g["sh_rest"].shape) * 0.1).astype(np.float32)
    g["opacity_logit"] = g["opacity_logit"] + 2.0
    g["log_scales"] = g["log_scales"] + (rng.normal(size=g["log_scales"].shape)
                                         * 0.3).astype(np.float32)
    np_params["knot_deltas"] = (rng.normal(size=np_params["knot_deltas"].shape)
                                * 0.005).astype(np.float32)
    # exposures that differ per frame: the novel views interpolate them
    np_params["log_exposures"] = np_params["log_exposures"] + rng.uniform(
        -0.3, 0.1, size=4).astype(np.float32)
    tj.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tt = TorchTrainer(_eval_cfg(t_config), _port_dataset(ds_j), device="cpu")
    tt.params = convert.params_from_jax(np_params, device="cpu")
    assert list(tt.dataset.eval_indices) == [0, 2] == list(tj.dataset.eval_indices)
    return tj, tt


@pytest.mark.parametrize("indices", [None, [1, 3]], ids=["held_out", "indices"])
def test_evaluate_matches_reference(trainers, indices):
    tj, tt = trainers
    want = tj.evaluate(indices=indices)
    got = tt.evaluate(indices=indices)
    assert sorted(got) == sorted(want)
    expected = {"eval_psnr", "eval_ssim", "eval_ms_ssim", "eval_sharp_psnr", "eval_sharp_ssim",
                "eval_sharp_ms_ssim", "eval_sharp_psnr_input"}
    if indices is None:
        expected |= {"eval_novel_psnr", "eval_novel_ssim"}
    assert set(got) == expected
    for key, value in want.items():
        atol = PSNR_ATOL if "psnr" in key else SSIM_ATOL
        np.testing.assert_allclose(got[key], value, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("indices", [None, [1, 3]], ids=["held_out", "indices"])
def test_graphed_evaluate_equals_eager_with_one_read_a_frame(trainers, monkeypatch, indices):
    _, tt = trainers
    want = tt.evaluate(indices=indices, graphed=False)
    reads = []
    tolist = torch.Tensor.tolist
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "tolist", lambda x: reads.append("tolist") or tolist(x))
    monkeypatch.setattr(torch.Tensor, "cpu", lambda x, *a, **k: reads.append("cpu")
                        or cpu(x, *a, **k))
    descents.use_stand_in(monkeypatch)
    monkeypatch.setattr(tt, "renders", imf.GraphedRenders())
    got = tt.evaluate(indices=indices)
    assert got == want
    frames = 2
    # one read of each frame's vectors; the exposures once for the novel views
    assert reads == (["cpu"] if indices is None else []) + ["tolist"] * frames
    assert [c.name for c in descents.CallingStandIn.made] == [
        "the blurred frame and its metric vector",
        "render_deblurred (hdr False, exposure given False, scored True)",
    ] + (["render_deblurred (hdr False, exposure given True, scored True)"]
         if indices is None else [])


def test_a_concurrent_render_leaves_the_novel_metrics_unchanged(trainers, monkeypatch):
    _, tt = trainers
    want = tt.evaluate(graphed=False)
    descents.use_stand_in(monkeypatch)
    renders = imf.GraphedRenders()
    monkeypatch.setattr(tt, "renders", renders)
    viewmat = torch.eye(4)
    viewmat[2, 3] = 4.0
    servers = []
    replay = descents.CallingStandIn.__call__

    def replay_after_a_request(stand_in):
        if stand_in.name.startswith("render_deblurred (hdr False, exposure given True") \
                and not servers:
            # a request at another exposure, in the buffer the novel view filled
            server = threading.Thread(target=renders.render_pose,
                                      args=(tt.params, tt.scene, viewmat, tt.cfg.model),
                                      kwargs={"exposure": 7.0})
            server.start()
            server.join(timeout=0.5)  # it has run by now unless it waits for this replay
            servers.append(server)
        return replay(stand_in)

    monkeypatch.setattr(descents.CallingStandIn, "__call__", replay_after_a_request)
    got = tt.evaluate()
    for server in servers:
        server.join()
    assert len(servers) == 1 and not servers[0].is_alive()
    assert got == want
    assert "render_pose (hdr False, depth False)" in [c.name for c in
                                                     descents.CallingStandIn.made]
