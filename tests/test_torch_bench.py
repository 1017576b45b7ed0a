"""Port parity: casualhdrsplat_torch.bench.build against the reference's
`bench.build` at a tiny size (400 Gaussians, 64x64, 2 views, 16x16 tiles),
the reference under `jax.jit` with backend "auto" (its XLA compositor on a
CPU; no tile list overflows at this size), the port on CPU tensors (the
plain versions of its kernels).  The CRF is carried across: `crf.create`
draws its jitter differently in each package (ROADMAP.md §C).

Tolerances: the loss within 1e-5 relative; each of the six gradients
within 1e-4 of its largest value plus rtol 1e-3 (the compositor's
backward sums a slot's terms in another order)."""

import jax
import numpy as np
import pytest
import torch

import bench as j_bench
from casualhdrsplat_torch import bench as t_bench
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TINY = dict(n_gaussians=400, size=64, n_virtual=2, chunk=32, stream_factor=6, tile=(16, 16))
NAMES = ("means", "log_scales", "opacity_logit", "colors", "crf", "log_dt")


@pytest.fixture(scope="module")
def steps():
    step_j, args_j, pix_j = j_bench.build(**TINY)
    step_t, args_t, pix_t = t_bench.build(**TINY, device="cpu")
    assert pix_t == pix_j == 64 * 64 * 2
    # the reference's CRF into the port's arguments
    crf = {k: torch.as_tensor(np.array(v)) for k, v in args_j[4].items()}
    args_t = args_t[:4] + (crf,) + args_t[5:]
    loss_j, grads_j = jax.jit(step_j)(*args_j)
    loss_t, grads_t = step_t(*args_t)
    return args_j, args_t, (float(loss_j), grads_j), (float(loss_t), grads_t)


def test_build_inputs_match(steps):
    args_j, args_t, _, _ = steps
    for name, a, b in zip(NAMES, args_t, args_j):
        if name == "crf":
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_loss_matches(steps):
    _, _, (loss_j, _), (loss_t, _) = steps
    assert np.isfinite(loss_t) and loss_t > 0
    assert loss_t == pytest.approx(loss_j, rel=1e-5)


@pytest.mark.parametrize("i", range(6), ids=NAMES)
def test_gradient_matches(steps, i):
    _, _, (_, grads_j), (_, grads_t) = steps
    got, want = grads_t[i], grads_j[i]
    if NAMES[i] == "crf":
        pairs = [(got[k].numpy(), np.asarray(want[k])) for k in sorted(want)]
        assert sorted(got) == sorted(want)
    else:
        pairs = [(got.numpy(), np.asarray(want))]
    for a, b in pairs:
        largest = float(np.abs(b).max())
        assert largest > 0 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4 * largest, rtol=1e-3)


def test_main_needs_the_card_unless_asked_for_the_cpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_bench.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_main_on_the_cpu_prints_its_line(capsys, monkeypatch):
    import json

    build = t_bench.build
    monkeypatch.setattr(t_bench, "build", lambda **kw: build(
        **dict(kw, n_gaussians=200, size=32, n_virtual=2, chunk=32)))
    monkeypatch.setattr(t_bench, "ITERS_PER_WINDOW", 2)
    assert t_bench.main(["--device", "cpu", "--tile", "16x16"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "rendered Mpix/s/chip fwd+bwd" and line["unit"] == "Mpix/s"
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / 10,
                                                                     abs=1e-3)
    assert line["median_of"] == 3 and line["iters_per_window"] == 2
    assert len(line["windows"]) == 3 and line["spread_pct"] >= 0
