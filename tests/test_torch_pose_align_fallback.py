"""The pose aligners' Adam against optax.adam's float32 arithmetic, and the
window realigner's parity on the initialisation a fresh checkout gives.

The reference initialises Gaussian scales with the native k-NN library
(native/libchs_native.so) when it is built and with a NumPy fallback
otherwise; tests/test_native.py builds the library in the middle of a test
run.  So tests/test_torch_pose_align.py's fixture got one initialisation or
the other depending on whether test_native.py had already run in some
worker.  On the fallback's, the end window's parity failed (loss 6.455e-3
against 6.459e-3 at step 4): the port's Adam evaluated its bias
corrections 1 - b ** count in Python floats, optax in float32 (1 - 0.999
is 1.3e-5 off there), which moved the first step by 7e-6 of lr, and this
steep loss grew that past the tolerance.  `_adam_descent` now rounds as
optax does.

- `_adam_descent` against optax.adam on a steep quadratic: the iterates at
  rtol 2e-7 (one float32 rounding), the loss curve at rtol 1e-6;
- the end window's realigner parity with the reference's k-NN forced onto
  its fallback, at tests/test_torch_pose_align.py's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_pose_align as pa
from casualhdrsplat_torch.train import pose_align as t_pa
from casualhdrsplat_tpu.data import _native as j_native
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_adam_descent_rounds_as_optax():
    rng = np.random.default_rng(4)
    w = rng.uniform(0.1, 50.0, 6).astype(np.float32)
    c = rng.normal(size=6).astype(np.float32)
    lr, steps = 5e-3, 8

    def loss_j(x):
        return jnp.sum(w * (x - c) ** 2)

    opt = optax.adam(lr)

    @jax.jit
    def run_j(x):
        def step(carry, _):
            x, s = carry
            val, g = jax.value_and_grad(loss_j)(x)
            u, s = opt.update(g, s, x)
            return (optax.apply_updates(x, u), s), (val, x)

        (x, _), (curve, xs) = jax.lax.scan(step, (x, opt.init(x)), None, length=steps)
        return x, curve, xs

    x_j, curve_j, _ = run_j(jnp.zeros(6, jnp.float32))
    wt, ct = torch.as_tensor(w), torch.as_tensor(c)
    x_t, curve_t = t_pa._adam_descent(lambda x: torch.sum(wt * (x - ct) ** 2),
                                      torch.zeros(6), steps, lr)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=2e-7, atol=0)
    np.testing.assert_allclose(curve_t.numpy(), np.asarray(curve_j), rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def fallback_pair():
    """tests/test_torch_pose_align.py's packed pair with the reference's
    k-NN on its NumPy fallback, as on a checkout without the native
    library."""
    load = j_native.load
    j_native.load = lambda: None
    try:
        return pa.make_pair(packed=True)
    finally:
        j_native.load = load


def test_end_window_realigner_matches_reference_on_the_fallback_init(fallback_pair):
    pa.check_window_realigner(fallback_pair, 3)
