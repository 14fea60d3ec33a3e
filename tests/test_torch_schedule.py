"""The port's cyclical schedule equals the JAX package's host schedule at
every step (mirrors tests/test_schedule.py)."""

import numpy as np
import pytest

from bayesdll_tpu.core.schedule import CyclicalSchedule as JSchedule
from bayesdll_tpu_torch.core.schedule import CyclicalSchedule


@pytest.mark.parametrize("epochs,cycles,bpe,prop", [
    (8, 4, 10, 0.5),      # integer cycle length
    (4, 2, 25, 0.5),
    (5, 3, 7, 0.3),       # K % M != 0: non-integer cycle length
    (3, 7, 11, 0.8),
    (1, 1, 13, 0.0),
    (2, 4, 9, 1.0),
])
def test_every_step_matches_jax(epochs, cycles, bpe, prop):
    kw = dict(base_lr=0.1, num_cycles=cycles, epochs=epochs,
              batches_per_epoch=bpe, proportion_exploration=prop)
    j, t = JSchedule(**kw), CyclicalSchedule(**kw)
    assert t.sample_threshold == j.sample_threshold
    assert t.cycle_length_int == j.cycle_length_int
    for step in range(j.total_iters):
        assert t.lr_py(step) == j.lr_py(step), step
        assert t.should_sample_py(step) == j.should_sample_py(step), step
        assert t.last_in_cycle_py(step) == j.last_in_cycle_py(step), step
        assert t.cycle_number_py(step) == j.cycle_number_py(step), step


def test_large_step_range_matches_jax():
    """Exact integer phases past where a float modulo misfires."""
    kw = dict(base_lr=0.1, num_cycles=7, epochs=30_000,
              batches_per_epoch=10_000, proportion_exploration=0.3)
    j, t = JSchedule(**kw), CyclicalSchedule(**kw)
    K, M = t.total_iters, t.num_cycles
    steps = set(int(s) for s in np.random.default_rng(0).integers(0, K, 200))
    for c in range(1, M + 1):
        b = (c * K) // M
        steps |= {b - 1, b % K, (b + 1) % K}
    for s in sorted(steps):
        assert t.should_sample_py(s) == j.should_sample_py(s) == \
            ((s * M) % K / K >= 0.3)
        assert t.last_in_cycle_py(s) == j.last_in_cycle_py(s)
        assert t.cycle_number_py(s) == j.cycle_number_py(s)
        assert t.lr_py(s) == j.lr_py(s)
