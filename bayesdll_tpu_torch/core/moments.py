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

`update_masked` is the fused path's form (methods/graphed.py): a captured
CUDA graph cannot branch on the host or read the host count, so the
collect flag and the count come as 0-d tensors on the vectors' device,
and the update advances that count in place.  Where collect is 1 it
writes `update`'s bits; where it is 0 the moments keep theirs.  The host
count catches up at the segment's end (`advance`), from the collect flags
the host computed.  It divides as `update` does, so the two agree bit for
bit on each device (`div_as_host_scalar`).  `clear` and `reset_from`
reset the moments in place, so a captured graph that reads them keeps
reading the live ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

VAR_FLOOR = 1e-12


def div_as_host_scalar(x: torch.Tensor, divisor: torch.Tensor):
    """x / divisor (a 0-d tensor) rounded as `x / float(divisor)` is: on the
    card PyTorch divides by a host scalar as a multiplication by its fp32
    reciprocal; on the CPU it divides.  Returns a new tensor."""
    if x.is_cuda:
        return x * torch.reciprocal(divisor)
    return x / divisor


def _masked_write_(dst: torch.Tensor, collect: torch.Tensor,
                   new: torch.Tensor):
    """dst <- new where collect (a 0-d tensor) is nonzero, in place."""
    torch.where(collect.bool(), new, dst, out=dst)


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

    def reset_from(self, theta: torch.Tensor) -> "RunningMoments":
        """init_from in place: mom1 = θ, mom2 = θ², cnt = 1."""
        self.mom1.copy_(theta)
        torch.mul(theta, theta, out=self.mom2)
        self.cnt = 1
        return self

    def clear(self) -> "RunningMoments":
        """zeros in place."""
        self.mom1.zero_()
        self.mom2.zero_()
        self.cnt = 0
        return self

    def update(self, theta: torch.Tensor) -> "RunningMoments":
        c = float(self.cnt)
        self.mom1.mul_(c).add_(theta).div_(c + 1.0)
        self.mom2.mul_(c).add_(theta * theta).div_(c + 1.0)
        self.cnt += 1
        return self

    def update_masked(self, theta: torch.Tensor, collect: torch.Tensor,
                      cnt: torch.Tensor) -> "RunningMoments":
        """update() iff `collect` (0-d fp32, 1 or 0), with the count before
        this step in `cnt` (0-d fp32), which advances by `collect` in place:
        nothing is read on the host (counterpart of the JAX package's
        update_masked, in this class's arithmetic)."""
        for mom, x in ((self.mom1, theta), (self.mom2, theta * theta)):
            _masked_write_(mom, collect, div_as_host_scalar(
                (mom * cnt).add_(x), cnt + 1.0))
        cnt.add_(collect)
        return self

    def advance(self, collected: int):
        """The host count after `collected` masked updates that collected."""
        self.cnt += int(collected)

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

    # the count's advance per collected sample
    COUNT_STEP = 1

    @classmethod
    def zeros(cls, dim: int, device) -> "WelfordMoments":
        return cls(torch.zeros(dim, device=device),
                   torch.zeros(dim, device=device), 0)

    def clear(self) -> "WelfordMoments":
        """zeros in place."""
        self.mean.zero_()
        self.m2.zero_()
        self.n = 0
        return self

    def update(self, theta: torch.Tensor) -> "WelfordMoments":
        # divisor n + 1, the count before this sample plus one
        delta = theta - self.mean
        self.mean.add_(delta / float(self.n + 1))
        self.m2.add_(delta * (theta - self.mean))
        self.n += self.COUNT_STEP
        return self

    def update_masked(self, theta: torch.Tensor, collect: torch.Tensor,
                      cnt: torch.Tensor) -> "WelfordMoments":
        """update() iff `collect` (0-d fp32, 1 or 0), with the count before
        this step in `cnt` (0-d fp32), which advances by COUNT_STEP ×
        `collect` in place: nothing is read on the host.  The sums are
        those of update() (fp32 addition and multiplication commute bit for
        bit), with three [D] temporaries."""
        delta = theta - self.mean
        mean = div_as_host_scalar(delta, cnt + 1.0).add_(self.mean)
        m2 = torch.sub(theta, mean).mul_(delta).add_(self.m2)
        _masked_write_(self.mean, collect, mean)
        _masked_write_(self.m2, collect, m2)
        cnt.add_(collect * float(self.COUNT_STEP))
        return self

    def advance(self, collected: int):
        """The host count after `collected` masked updates that collected."""
        self.n += self.COUNT_STEP * int(collected)

    def mean_var(self):
        var = torch.clamp(self.m2 / max(float(self.n) - 1.0, 1.0),
                          min=VAR_FLOOR)
        return self.mean, var


class RefWelfordMoments(WelfordMoments):
    """The reference's doubled count, reproduced exactly (opt-in through
    BAYESDLL_TPU_REF_QUIRKS=welford_count): sample k uses divisor 2k-1 and
    the stored count advances by 2 per collected sample, which also doubles
    the variance denominator.  WelfordMoments' update with divisor n + 1
    and a count step of 2."""

    COUNT_STEP = 2
