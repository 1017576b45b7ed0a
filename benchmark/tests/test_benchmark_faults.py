"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (`harness.run_cell` on a tiny cell, the
look for a card skipped) with one fault planted in the system under
test, once for each fault the cell can have:
- training: a step that returns its state unchanged; half of the batch
  (the virtual views a blurred frame averages) left out, the mean taken
  over the rest;
- serving: an answer altered where it is produced (a tile of the
  rendered view zeroed; the previous request's image served again).
No cell spans chips, so no cell has an exchange between chips to leave
out.  A sound run of the same cells comes out correct."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import tiny_cell

QUIET = dict(log=lambda *a, **k: None)


def _run(workload, seed=987654321):
    return harness.run_cell(tiny_cell(workload), seed, 0.3, False, torch.device("cpu"), 0.0,
                            **QUIET)


@pytest.mark.parametrize("workload", ["ladder4.train", "ladder4-dense.train", "ladder4.serve"])
def test_a_sound_run_is_correct(workload):
    assert _run(workload)["correct"] is True


@pytest.mark.parametrize("workload", ["ladder4.train", "ladder4-dense.train"])
def test_a_step_that_leaves_its_state_unchanged(workload, monkeypatch):
    from casualhdrsplat_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "apply", lambda self, *a, **k: None)
    res = _run(workload)
    assert res["correct"] is False and res["checks"]["change_gap"]["value"] >= 0.99


@pytest.mark.parametrize("workload", ["ladder4.train", "ladder4-dense.train"])
def test_half_of_the_views_left_out(workload, monkeypatch):
    from casualhdrsplat_torch.models import image_formation as imf

    render = imf.render_frame

    def half(*args, **kw):
        out = render(*args, **kw)
        n = out.sharp_ldr.shape[0]
        return out._replace(blurred_ldr=out.sharp_ldr[:n // 2].mean(0))

    monkeypatch.setattr(imf, "render_frame", half)
    assert _run(workload)["correct"] is False


@pytest.mark.parametrize("workload", ["ladder4.serve", "ladder4-dense.serve"])
def test_an_altered_view(workload, monkeypatch):
    from casualhdrsplat_torch.models import image_formation as imf

    render = imf.GraphedRenders.render_pose

    def altered(self, *args, **kw):
        img, alpha, aux = render(self, *args, **kw)
        img = img.clone()
        h, w = img.shape[0] // 2, img.shape[1] // 2
        img[h - 4:h + 4, w - 8:w + 8] = 0.0  # a tile where the cloud is
        return img, alpha, aux

    monkeypatch.setattr(imf.GraphedRenders, "render_pose", altered)
    assert _run(workload)["correct"] is False


def test_a_stale_view(monkeypatch):
    from casualhdrsplat_torch.models import image_formation as imf

    render = imf.GraphedRenders.render_pose
    last = []

    def stale(self, *args, **kw):
        out = render(self, *args, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    monkeypatch.setattr(imf.GraphedRenders, "render_pose", stale)
    assert _run("ladder4.serve")["correct"] is False
