"""Port parity: models/crf.py against the JAX reference.

`apply` on carried weights: atol 1e-6.  The gamma pre-fit: two Adam
implementations (torch.optim.Adam vs optax.adam, same defaults) over 1200
steps from the same start, compared as response curves at atol 1e-4
(measured 7e-7 on the CPU); `create` with its own jitter draw at 1e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from casualhdrsplat_torch import config as t_config
from casualhdrsplat_torch.models import crf as t_crf
from casualhdrsplat_tpu import config as j_config
from casualhdrsplat_tpu.models import crf as j_crf


def _cfgs(**kw):
    return t_config.CRFConfig(**kw), j_config.CRFConfig(**kw)


def _np_params(p):
    return {k: np.array(v, np.float32) for k, v in p.items()}


@pytest.mark.parametrize("kind", ["mlp", "gamma", "identity"])
def test_apply_on_carried_weights(rng, kind):
    ct, cj = _cfgs(kind=kind, hidden=8, init_gamma=0.0)
    pj = j_crf.create(cj, jax.random.PRNGKey(1))
    if pj:  # perturb so every unit contributes differently
        pj = {k: v + 0.3 * rng.normal(size=v.shape).astype(np.float32) for k, v in pj.items()}
    pt = {k: torch.from_numpy(v) for k, v in _np_params(pj).items()}
    e = np.exp(rng.uniform(-11, 5, size=(4, 6, 3))).astype(np.float32)
    e[0, 0] = 0.0
    np.testing.assert_allclose(t_crf.apply(pt, torch.from_numpy(e), ct),
                               j_crf.apply(pj, jnp.asarray(e), cj), atol=1e-6)
    ex_t, ldr_t = t_crf.response_curve(pt, ct, 64, device="cpu")
    ex_j, ldr_j = j_crf.response_curve(pj, cj, 64)
    np.testing.assert_allclose(ex_t, ex_j, rtol=1e-5)
    np.testing.assert_allclose(ldr_t, ldr_j, atol=1e-6)


def test_prefit_to_gamma_matches_optax():
    ct, cj = _cfgs(hidden=8)
    start = j_crf.create(dataclasses.replace(cj, init_gamma=0.0), jax.random.PRNGKey(0))
    fit_j = j_crf._prefit_to_gamma(start, cj)
    fit_t = t_crf._prefit_to_gamma(
        {k: torch.from_numpy(v) for k, v in _np_params(start).items()}, ct
    )
    _, curve_t = t_crf.response_curve(fit_t, ct)
    _, curve_j = j_crf.response_curve(fit_j, cj)
    np.testing.assert_allclose(curve_t, curve_j, atol=1e-4)
    # create() itself: a different jitter draw, the same fitted curve family
    created = t_crf.create(ct, torch.Generator().manual_seed(0), device="cpu")
    assert set(created) == set(fit_j)
    _, curve_c = t_crf.response_curve(created, ct)
    np.testing.assert_allclose(curve_c, curve_j, atol=1e-3)
    assert t_crf.create(_cfgs(kind="gamma")[0], device="cpu") == {}
