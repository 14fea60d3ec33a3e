"""Streaming posterior moments over the flat vector (counterpart of
bayesdll_tpu.core.moments: WelfordMoments and RefWelfordMoments).

cSGHMC keeps a Welford mean and M2 (sum of squared deviations) per cycle;
variance = M2 / (n - 1).  The update runs in place on the device tensors.
The count `n` is a host int: the runner decides on the host whether a step
collects, so reading the count never waits on the device.
"""

from __future__ import annotations

import dataclasses

import torch

VAR_FLOOR = 1e-12


@dataclasses.dataclass
class WelfordMoments:
    """Numerically stable mean + M2 accumulator (cSGHMC's scheme)."""

    mean: torch.Tensor
    m2: torch.Tensor
    n: int = 0

    @classmethod
    def zeros(cls, dim: int, device) -> "WelfordMoments":
        return cls(torch.zeros(dim, device=device),
                   torch.zeros(dim, device=device), 0)

    def _accumulate(self, theta: torch.Tensor, divisor: int):
        delta = theta - self.mean
        self.mean.add_(delta / float(divisor))
        self.m2.add_(delta * (theta - self.mean))

    def update(self, theta: torch.Tensor) -> "WelfordMoments":
        self.n += 1
        self._accumulate(theta, self.n)
        return self

    def mean_var(self):
        var = torch.clamp(self.m2 / max(float(self.n) - 1.0, 1.0),
                          min=VAR_FLOOR)
        return self.mean, var


class RefWelfordMoments(WelfordMoments):
    """The reference's doubled count, reproduced exactly (opt-in through
    BAYESDLL_TPU_REF_QUIRKS=welford_count): sample k uses divisor 2k-1 and
    the stored count advances by 2 per collected sample, which also doubles
    the variance denominator."""

    def update(self, theta: torch.Tensor) -> "RefWelfordMoments":
        self._accumulate(theta, self.n + 1)
        self.n += 2
        return self
