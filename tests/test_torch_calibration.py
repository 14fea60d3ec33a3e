"""Calibration metrics of the port against the JAX package (mirrors
tests/test_calibration.py)."""

import numpy as np
import pytest
import scipy.special

from bayesdll_tpu.utils import calibration as jcal
from bayesdll_tpu_torch.utils import calibration as tcal


def _logits(n=200, k=5, seed=0, scale=3.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, k).astype(np.float32) * scale,
            rng.randint(0, k, size=n))


@pytest.mark.parametrize("temp", [1.0, 2.5, 0.3])
@pytest.mark.parametrize("seed,k", [(0, 5), (1, 10), (2, 3)])
def test_metrics_match_jax(temp, seed, k):
    logits, labels = _logits(k=k, seed=seed)
    jm = jcal.compute_metrics(labels, logits, 15, temp)
    tm = tcal.compute_metrics(labels, logits, 15, temp)
    np.testing.assert_allclose(tm, jm, atol=1e-5)


def test_bins_match_jax():
    logits, labels = _logits(n=500, k=10, seed=4)
    jb = jcal.calc_bins(labels, logits, 15, 1.0)
    tb = tcal.calc_bins(labels, logits, 15, 1.0)
    for a, b in zip(tb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_perfectly_calibrated_ece_zero():
    n, k = 64, 4
    labels = np.arange(n) % k
    logits = np.full((n, k), -20.0, np.float32)
    logits[np.arange(n), labels] = 20.0
    ece, mce, nll = tcal.compute_metrics(labels, logits, 15)
    assert ece < 1e-5 and nll < 1e-5


def test_optimal_temperature_matches_jax():
    rng = np.random.RandomState(1)
    true_logits = rng.randn(2000, 3) * 2.0
    probs = scipy.special.softmax(true_logits, axis=1)
    labels = np.array([rng.choice(3, p=p) for p in probs])
    sharp = true_logits * 4.0
    t_topt, t_ok = tcal.find_optimal_temperature(labels, sharp)
    j_topt, j_ok = jcal.find_optimal_temperature(labels, sharp)
    assert t_ok and j_ok
    assert abs(t_topt - j_topt) < 1e-6
    assert 3.0 < t_topt < 5.5
    _, _, nll_t1 = tcal.compute_metrics(labels, sharp, 15, 1.0)
    _, _, nll_topt = tcal.compute_metrics(labels, sharp, 15, t_topt)
    assert nll_topt < nll_t1
