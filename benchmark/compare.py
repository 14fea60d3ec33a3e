"""The comparisons that decide `correct`.

A training cell compares the first steps of the program with the
reference's (the reference follows the same inputs, weights, step sizes
and noise):
  * `loss_gap`: the largest relative gap of a step's loss;
  * `grad_gap`: the first gradient as the update received it;
  * `change_gap`: theta's change after the steps;
  * `welford_mean_gap`, `welford_var_gap`: the moments' mean (its change
    from the start) and variance after the steps.
Each vector number is taken part by part (a leaf, a stacked leaf layer by
layer): the gap between the program's norm of the part and the
reference's, over the larger of the reference's norm of that part and of
the median part, and the worst part gives the number; `<name>_median_gap`
is the median part's gap, a steadier reading of the same quantity.  Parts whose
reference gradient is below a thousandth of the median part's are left
out of the last three: their moves are round-off.

A predictive cell compares the mixture's log-probabilities of a sample of
its batches: `logp_max_gap`, the largest absolute gap, and
`logp_mean_gap`, the mean one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

ROUNDOFF = 1e-3


@dataclasses.dataclass
class StepReadings:
    """What the first steps leave, from the program or the reference:
    each step's loss; the first gradient; theta, and the moments' mean and
    variance, after the steps (float32 [dim] on one device)."""
    losses: List[float]
    grad: torch.Tensor
    theta: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor


def part_norms(vec: torch.Tensor, groups) -> torch.Tensor:
    """float64 norms of each (name, start, size) part of vec."""
    return torch.stack([torch.linalg.vector_norm(
        vec[s:s + n].double()) for _, s, n in groups]).cpu()


def part_gaps(prog: torch.Tensor, ref: torch.Tensor,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each part's gap: |prog - ref| of its norms over the larger of the
    reference's norm of the part and of the median part; 0 where `keep`
    is False."""
    floor = torch.maximum(ref, ref.median())
    gap = (prog - ref).abs() / floor.clamp(min=1e-300)
    return gap if keep is None else torch.where(keep, gap,
                                                torch.zeros_like(gap))


def steps(prog: StepReadings, ref: StepReadings, theta0: torch.Tensor,
          groups) -> dict:
    """The training cell's numbers, with the worst part of each."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                           zip(prog.losses, ref.losses))}
    g_ref = part_norms(ref.grad, groups)
    keep = g_ref >= ROUNDOFF * g_ref.median()
    pairs = {
        "grad_gap": (prog.grad, ref.grad, None),
        "change_gap": (prog.theta - theta0, ref.theta - theta0, keep),
        "welford_mean_gap": (prog.mean - theta0, ref.mean - theta0, keep),
        "welford_var_gap": (prog.var, ref.var, keep),
    }
    worst = {}
    for name, (a, b, k) in pairs.items():
        gap = part_gaps(part_norms(a, groups), part_norms(b, groups), k)
        i = int(torch.argmax(gap))
        out[name] = float(gap[i])
        kept = gap if k is None else gap[k]
        out[name.replace("_gap", "_median_gap")] = float(kept.median())
        worst[name] = groups[i][0]
    return {"numbers": out, "worst_part": worst,
            "left_out": [groups[i][0] for i in range(len(groups))
                         if not bool(keep[i])]}


def logp(prog_logp: torch.Tensor, ref_logp: torch.Tensor) -> dict:
    gap = (prog_logp.double() - ref_logp.double()).abs()
    return {"logp_max_gap": float(gap.max()),
            "logp_mean_gap": float(gap.mean())}


def judge(numbers: dict, limits: dict):
    """(every compared number within its limit, the lines that say so).
    A number missing or not finite fails."""
    ok, lines = True, {}
    for name, lim in limits.items():
        value = numbers.get(name)
        passed = value is not None and value == value \
            and value <= lim["limit"]
        ok &= passed
        lines[name] = {"value": value, "limit": lim["limit"]}
    return ok, lines
