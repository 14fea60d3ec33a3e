#!/usr/bin/env python3
"""The ViT-L/32 cSGHMC step with two forms of the bf16 cast of θ at the
unravel, in turns on one card.  Needs one CUDA card.

    python3 vit_cast_forms.py

The port's form (`FlatTarget.leaves`) casts each leaf of θ into its own
allocation.  The JAX package's form casts θ in one op and unravels views of
the result; those views start at θ's offsets, which for 37 classes leave
every leaf after the head off 16-byte alignment.  The script builds
chip_smoke.py's ViT-L/32 run (37 classes, batch 128, bf16), times 6 steps
of each form on the run's batches already on the card, in the order per
leaf, contiguous, contiguous, per leaf, and prints the ms/step of each,
then the device time by kernel family of the contiguous form.
"""

from __future__ import annotations

import dataclasses
import sys

import torch

import chip_smoke as cs


def main() -> int:
    if not torch.cuda.is_available():
        print("vit_cast_forms: no CUDA device", file=sys.stderr)
        return 1
    from bayesdll_tpu_torch.core import flat as flat_util

    smi = cs.phase_device()
    runner, loaders = cs.vit_runner()
    runner._ensure_sched(len(loaders[0]))
    xs, ys = cs.device_batches(loaders[0])
    xs = [xs[i % len(xs)] for i in range(cs.VIT_STEPS)]
    ys = [ys[i % len(ys)] for i in range(cs.VIT_STEPS)]
    target = runner.target
    dt = getattr(torch, target.fwd_cast)
    contiguous = dataclasses.replace(target)
    contiguous.leaves = lambda theta: flat_util.dotted(
        target.unravel(theta.to(dt)))
    ms = {"per leaf": [], "contiguous": []}
    for form in ("per leaf", "contiguous", "contiguous", "per leaf"):
        runner.target = target if form == "per leaf" else contiguous
        ms[form].append(1e3 * cs.host_s_per_step(
            runner, xs, ys, f"vit_l_32 {form} cast", warmup=1)[0])
    print(f"[{smi}] csghmc training step vit_l_32 bf16 batch "
          f"{runner.cfg.batch_size}, {len(xs)} steps each, in turns: theta "
          f"cast per leaf (aligned) {ms['per leaf'][0]:.2f} and "
          f"{ms['per leaf'][1]:.2f} ms/step; one contiguous cast (views at "
          f"theta's offsets) {ms['contiguous'][0]:.2f} and "
          f"{ms['contiguous'][1]:.2f} ms/step", flush=True)
    runner.target = contiguous
    cs.phase_profile(smi, "csghmc vit_l_32 contiguous cast", runner, xs[:2],
                     ys[:2], sum(ms["contiguous"]) / 2, "csghmc_update")
    return 0


if __name__ == "__main__":
    sys.exit(main())
