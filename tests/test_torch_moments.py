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


@pytest.mark.parametrize("seeded", [False, True], ids=["zeros", "init_from"])
@pytest.mark.parametrize("n_updates", [1, 2, 7])
def test_running_moments_match_jax(seeded, n_updates):
    dim = 1000
    rng = np.random.RandomState(10 + n_updates)
    first = (rng.randn(dim) * 2 + 0.5).astype(np.float32)
    samples = (rng.randn(n_updates, dim) * 3 + 1).astype(np.float32)
    if seeded:
        j = jmom.RunningMoments.init_from(jnp.asarray(first))
        t = tmom.RunningMoments.init_from(torch.from_numpy(first.copy()))
    else:
        j = jmom.RunningMoments.zeros(dim)
        t = tmom.RunningMoments.zeros(dim, "cpu")
    for s in samples:
        j = j.update(jnp.asarray(s))
        t = t.update(torch.from_numpy(s))
    assert t.cnt == int(j.cnt) == n_updates + seeded
    jm, jv = j.mean_var()
    tm, tv = t.mean_var()
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_running_moments_init_from_copies_theta():
    theta = torch.arange(8, dtype=torch.float32)
    m = tmom.RunningMoments.init_from(theta)
    theta.add_(100.0)  # the samplers write theta in place every step
    assert m.cnt == 1
    assert torch.equal(m.mom1, torch.arange(8, dtype=torch.float32))
    assert torch.equal(m.mom2, torch.arange(8, dtype=torch.float32) ** 2)
    mean, var = m.mean_var()
    assert torch.equal(mean, m.mom1)
    assert torch.all(var == tmom.VAR_FLOOR)


@pytest.mark.parametrize("name", ["RunningMoments", "WelfordMoments",
                                  "RefWelfordMoments"])
def test_zeros_takes_dim_and_device(name):
    # the cyclical runners reset any of them the same way at a cycle end
    m = getattr(tmom, name).zeros(16, torch.device("cpu"))
    mean, _ = m.mean_var()
    assert mean.shape == (16,) and mean.device.type == "cpu"
    assert not torch.any(mean)
