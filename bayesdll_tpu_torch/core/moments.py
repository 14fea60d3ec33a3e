"""Streaming posterior moments over the flat vector (counterpart of
bayesdll_tpu.core.moments).

  * RunningMoments (SGLD, SGHMC, cSGLD): running means of θ and θ²,
    mom1 <- (θ + cnt·mom1) / (cnt + 1); var = cnt/(cnt-1) · (mom2 - mom1²).
  * WelfordMoments (cSGHMC): Welford mean and M2 (sum of squared
    deviations) per cycle; variance = M2 / (n - 1).
  * RefWelfordMoments: the reference's doubled Welford count.

The updates run in place on the device tensors.  The counts (`cnt`, `n`,
named as in the JAX package) are host ints: the runner decides on the host
whether a step collects, so reading a count never waits on the device.
The JAX package's `update_masked` serves only its scanned multi-step
program, which decides on the device; the port has no counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

VAR_FLOOR = 1e-12


@dataclasses.dataclass
class RunningMoments:
    """First and second raw moments with an update count."""

    mom1: torch.Tensor
    mom2: torch.Tensor
    cnt: int = 0

    @classmethod
    def zeros(cls, dim: int, device) -> "RunningMoments":
        return cls(torch.zeros(dim, device=device),
                   torch.zeros(dim, device=device), 0)

    @classmethod
    def init_from(cls, theta: torch.Tensor) -> "RunningMoments":
        """Seeded with one sample, cnt = 1.  mom1 is a copy: the samplers
        write θ in place, and an alias would move with every step."""
        return cls(theta.clone(), theta * theta, 1)

    def update(self, theta: torch.Tensor) -> "RunningMoments":
        c = float(self.cnt)
        self.mom1.mul_(c).add_(theta).div_(c + 1.0)
        self.mom2.mul_(c).add_(theta * theta).div_(c + 1.0)
        self.cnt += 1
        return self

    def mean_var(self):
        ratio = float(np.float32(self.cnt) / np.float32(max(self.cnt - 1, 1)))
        var = torch.clamp(ratio * (self.mom2 - self.mom1 * self.mom1),
                          min=VAR_FLOOR)
        return self.mom1, var


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
