"""The control of `correct` on the card: the plain reference computed
with TF32 matrix products and convolutions, put in the program's place,
fails every cell's limits (a training cell's by the first gradient
element by element), and so does a planted fault a training cell's,
while the program passes them.  At a size a test run holds (32,768
Gaussians at 400x400); benchmark/control.py reads the same at the cells'
own size.  Run on the card:

    python -m pytest benchmark/tests -m cuda -q
"""

from __future__ import annotations

import copy

import pytest
import torch

from benchmark import compare, harness, loops


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the control is TF32, a precision of the card)")
    return torch.device("cuda", 0)


def _small(workload):
    cell = harness.resolve(harness.load_spec(), workload)
    config = copy.deepcopy(cell.config)
    config["config"]["model"]["max_gaussians"] = 32768
    config["assumed"]["scene"].update(gaussians=32768, size=400)
    traffic = dict(cell.traffic, trace_steps=2, sample=4, warmup_per_mode=1)
    return cell._replace(config=config, traffic=traffic)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ladder4.serve", "ladder4-dense.serve", "ladder4.train",
                                      "ladder4-dense.train"])
def test_tf32_control_fails_and_the_program_passes(card, workload):
    cell = _small(workload)
    loop = loops.load_kind(cell.traffic["kind"])(cell, 2 ** 31 + 77, card)
    loop.setup()
    if cell.traffic["kind"] == "serve":
        loop.window(1.0)
    loop.release()
    reference = loop.reference()
    assert compare.judge(loop.readings(reference), cell.limits)[0]
    assert not compare.judge(loop.control_readings(reference), cell.limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ladder4.train", "ladder4-dense.train"])
def test_training_cells_fail_a_planted_fault_and_the_program_passes(card, workload):
    """The reference blurring half of the virtual views, put in the
    program's place."""
    cell = _small(workload)
    loop = loops.load_kind("train")(cell, 2 ** 31 + 77, card)
    loop.setup()
    loop.release()
    reference = loop.reference()
    assert compare.judge(loop.readings(reference), cell.limits)[0]
    half = cell.config["config"]["model"]["num_virtual_views"] // 2
    assert not compare.judge(compare.train_gaps(loop.reference(views=half), reference),
                             cell.limits)[0]
