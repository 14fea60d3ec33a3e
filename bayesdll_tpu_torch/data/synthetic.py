"""Deterministic synthetic classification task.

New component (no reference equivalent — the reference always downloads
torchvision datasets, `datasets.py:8-56`).  Used by the test-suite and the
throughput benchmark: a Gaussian-mixture task (one random prototype per
class, isotropic within-class noise) that is seedable, learnable, and needs
no files or network.  `noise` tunes difficulty: generalisation error decays
smoothly with it, so tests can assert "clearly better than chance" without
flakiness.
"""

from __future__ import annotations

import numpy as np


def make_synthetic(n_train=4096, n_test=1024, input_shape=(784,),
                   num_classes=10, seed=0, noise=1.0):
    rng = np.random.RandomState(seed + 1234)
    d = int(np.prod(input_shape))
    prototypes = rng.randn(num_classes, d).astype(np.float32)

    def gen(n):
        y = rng.randint(0, num_classes, size=n).astype(np.int32)
        x = prototypes[y] + noise * rng.randn(n, d).astype(np.float32)
        return x.reshape((n,) + tuple(input_shape)), y

    xtr, ytr = gen(n_train)
    xte, yte = gen(n_test)
    return (xtr, ytr), (xte, yte), num_classes
