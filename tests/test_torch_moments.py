"""Welford moments of the port against the JAX package on one update
sequence (bayesdll_tpu.core.moments)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesdll_tpu.core import moments as jmom
from bayesdll_tpu_torch.core import moments as tmom


@pytest.mark.parametrize("name", ["WelfordMoments", "RefWelfordMoments"])
@pytest.mark.parametrize("n_updates", [1, 2, 7])
def test_same_mean_and_var_as_jax(name, n_updates):
    dim = 1000
    rng = np.random.RandomState(n_updates)
    samples = (rng.randn(n_updates, dim) * 3 + 1).astype(np.float32)
    j = getattr(jmom, name).zeros(dim)
    t = getattr(tmom, name).zeros(dim, "cpu")
    for s in samples:
        j = j.update(jnp.asarray(s))
        t = t.update(torch.from_numpy(s))
    assert t.n == int(j.n)
    jm, jv = j.mean_var()
    tm, tv = t.mean_var()
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_welford_against_numpy():
    rng = np.random.RandomState(0)
    samples = rng.randn(20, 500).astype(np.float32)
    t = tmom.WelfordMoments.zeros(500, "cpu")
    for s in samples:
        t.update(torch.from_numpy(s))
    mean, var = t.mean_var()
    np.testing.assert_allclose(mean.numpy(), samples.mean(0), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), samples.var(0, ddof=1), rtol=1e-4)
