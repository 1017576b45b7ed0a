"""The port's viewer (casualhdrsplat_torch/viewer/server.py):
tests/test_viewer_video.py::test_viewer_serves_renders run against the
port, `make_orbit_render_fn` on a tiny trainer against the reference's
render of the same parameters (atol 1e-4, the renders' agreement in
tests/test_torch_image_formation.py), and a request that arrives during
a training step waits for the step (the trainer's lock).
"""

import dataclasses
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch import convert
from casualhdrsplat_torch.data import dataset as t_dataset
from casualhdrsplat_torch.train.trainer import Trainer as TorchTrainer
from casualhdrsplat_torch.viewer.server import ViewerServer, make_orbit_render_fn
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.data import dataset as j_dataset
from casualhdrsplat_tpu.train.trainer import Trainer as JaxTrainer
from casualhdrsplat_tpu.viewer import server as j_server
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_viewer_serves_renders():
    calls = {}

    def render(angle, log_exposure, mode):
        calls["last"] = (angle, log_exposure, mode)
        return np.full((8, 8, 3), 0.5, np.float32)

    server = ViewerServer(render, host="127.0.0.1", port=0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        page = urllib.request.urlopen(base + "/", timeout=10).read()
        assert b"viewer" in page
        jpg = urllib.request.urlopen(
            base + "/render.jpg?angle=0.5&log_exposure=-1.0&mode=hdr", timeout=10).read()
        assert jpg[:2] == b"\xff\xd8"  # JPEG magic
        assert calls["last"] == (pytest.approx(0.5), pytest.approx(-1.0), "hdr")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/nothing", timeout=10)
        assert exc.value.code == 404

        def bad(angle, log_exposure, mode):
            raise RuntimeError("boom")

        server.render_fn = bad  # an error surfaces as a 500, not a hang
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/render.jpg", timeout=10)
        assert exc.value.code == 500
    finally:
        server.stop()


def _cfg(mod):
    cfg = mod.TrainConfig(name="viewer")
    cfg.model.max_gaussians = 128
    cfg.model.sh_degree = 1
    cfg.model.num_virtual_views = 2
    cfg.model.crf = mod.CRFConfig(kind="mlp", hidden=8)
    # the packed path; the reference composites it in XLA on the CPU
    cfg.model.rasterize = mod.RasterizeConfig(tile_h=8, tile_w=16, max_tiles_per_gaussian=32,
                                              chunk=32)
    cfg.densify.enabled = False
    cfg.data.eval_every = 0
    return cfg


@pytest.fixture(scope="module")
def trainers():
    ds_t = t_dataset.make_synthetic_dataset(seed=3, n_gaussians=96, n_frames=4, n_virtual=2,
                                            size=32, device="cpu")
    ds_j = j_dataset.Dataset(**{f.name: getattr(ds_t, f.name)
                                for f in dataclasses.fields(t_dataset.Dataset)})
    tj = JaxTrainer(_cfg(j_config), ds_j)
    np_params = jax.tree_util.tree_map(lambda a: np.array(a), tj.params)
    np_params["gaussians"]["opacity_logit"] += 2.0
    tj.params = jax.tree_util.tree_map(jnp.asarray, np_params)
    tt = TorchTrainer(_cfg(t_config), ds_t, device="cpu")
    tt.params = convert.params_from_jax(np_params, device="cpu")
    return tj, tt


@pytest.mark.parametrize("angle,log_exposure,mode", [(0.0, 0.0, "ldr"), (0.3, -0.7, "ldr"),
                                                     (-0.2, 0.4, "hdr")])
def test_orbit_render_matches_reference(trainers, angle, log_exposure, mode):
    tj, tt = trainers
    got = make_orbit_render_fn(tt)(angle, log_exposure, mode)
    want = np.asarray(j_server.make_orbit_render_fn(tj)(angle, log_exposure, mode))
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (32, 32, 3)
    assert want.max() > 0.05
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_render_waits_for_a_training_step(trainers):
    """A request that arrives while the trainer holds its lock (a step is
    writing the parameters in place) renders only after the step."""
    _, tt = trainers
    render = make_orbit_render_fn(tt)
    done = threading.Event()
    with tt.lock:
        worker = threading.Thread(target=lambda: (render(0.1, 0.0, "ldr"), done.set()))
        worker.start()
        assert not done.wait(0.5)
    worker.join(timeout=60)
    assert done.is_set() and not worker.is_alive()
