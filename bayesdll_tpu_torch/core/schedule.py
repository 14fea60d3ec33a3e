"""Cyclical SG-MCMC step-size schedule (counterpart of
bayesdll_tpu.core.schedule, host versions only).

The port drives every step from the host, so the schedule is plain Python on
exact integers.  With K = epochs * batches_per_epoch total steps, M cycles
and the 0-based global step s:
  lr:            cycle_length = K // M;  lr = base_lr * (1 + cos(pi * pos)) / 2
                 with pos = (s mod cycle_length) / cycle_length
  should_sample: ((s*M) mod K) / K >= proportion_exploration
  last_in_cycle: ((s+1)*M) mod K == 0
  cycle_number:  (s*M) // K + 1
The phase tests use ((s*M) mod K), i.e. frac(s / (K/M)) as an exact
rational, so they never misfire at a non-integer cycle length.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class CyclicalSchedule:
    base_lr: float
    num_cycles: int
    epochs: int
    batches_per_epoch: int
    proportion_exploration: float = 0.5

    @property
    def total_iters(self) -> int:
        return self.epochs * self.batches_per_epoch

    @property
    def cycle_length_int(self) -> int:
        return max(1, self.total_iters // self.num_cycles)

    @property
    def cycle_length_float(self) -> float:
        return self.total_iters / self.num_cycles

    @property
    def sample_threshold(self) -> int:
        """Smallest integer r in [0, K] with r/K >= proportion_exploration."""
        K = self.total_iters
        c = int(math.floor(self.proportion_exploration * K))
        for r in range(max(0, c - 2), min(K, c + 3)):
            if r / K >= self.proportion_exploration:
                return r
        return K

    def _frac_num_py(self, step: int) -> int:
        """(step * M) mod K with exact Python integers."""
        return (int(step) * self.num_cycles) % self.total_iters

    def lr_py(self, step: int) -> float:
        cl = self.cycle_length_int
        cycle_pos = (int(step) % cl) / cl
        return float(self.base_lr * (1.0 + np.cos(np.pi * cycle_pos)) / 2.0)

    def should_sample_py(self, step: int) -> bool:
        return self._frac_num_py(step) >= self.sample_threshold

    def last_in_cycle_py(self, step: int) -> bool:
        return self._frac_num_py(int(step) + 1) == 0

    def cycle_number_py(self, step: int) -> int:
        return (int(step) * self.num_cycles) // self.total_iters + 1
