"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size, in one process:

    python benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3]

For every seed the program's numbers against the reference (the lower
readings: the largest over sound runs).  For each control seed the
control, the reference computed with fp8 products in the program's place,
and the planted faults, each in the program's place against the reference
(the loop's `stand_ins()`; in a training cell a state left unchanged
reads 1 on the change and the moments and needs no run).
Prints one JSON line per reading and a summary: per number the lower
reading and each candidate upper reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import device, loops, spec  # noqa: E402


# numbers that a step returning its state unchanged reads as 1
UNCHANGED_READS_ONE = ("change_gap", "welford_mean_gap", "welford_var_gap")


def propose(summary: dict, training: bool) -> dict:
    """Limits from the readings: the upper reading is the least of the
    control's (where it is 3x the lower or more) and, in a training cell
    only, of each fault's that is 10x the lower or more (a state left unchanged,
    which reads 1 on the change and the moments: 3x); the limit lies at
    lower^(1/3) upper^(2/3), nearer the upper, so that fresh seeds have
    room above the dozen.  A number with no upper reading gets none."""
    out = {}
    for name, row in summary.items():
        lower = row["lower"]
        cands = {}
        for who, value in row.items():
            control = who.startswith("control")
            if who == "lower" or not (control or training):
                continue
            if value >= (3.0 if control else 10.0) * lower:
                cands[who] = value
        if training and name in UNCHANGED_READS_ONE \
                and 1.0 >= 3.0 * lower:
            cands["state_unchanged"] = 1.0
        if not cands:
            out[name] = {"lower": lower, "upper": None}
            continue
        who = min(cands, key=cands.get)
        upper = cands[who]
        out[name] = {"limit": float(f"{lower ** (1 / 3) * upper ** (2 / 3):.3g}"),
                     "lower": lower, "upper": upper, "upper_from": who}
    return out


def main(argv=None):
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    device.set_cache_dirs(ROOT)
    device.require_chips(1)
    cell = spec.load_cell(args.workload)
    loop_cls = loops.load(cell.traffic["loop"])
    control = {int(s) for s in args.control_seeds.split(",") if s}
    readings = {}
    for seed in [int(s) for s in args.seeds.split(",")]:
        tic = time.perf_counter()
        loop = loop_cls(cell, seed, "cuda")
        loop.setup(warm=False)
        loop.calibration_outputs()
        loop.free()
        t_check = time.perf_counter()
        checked = loop.check()
        got = {"program": checked["numbers"]}
        if "worst_part" in checked:
            print(json.dumps({"seed": seed, "worst_part":
                              checked["worst_part"]}), flush=True)
        check_s = time.perf_counter() - t_check
        if seed in control:
            got.update(loop.stand_ins())
        for who, nums in got.items():
            readings.setdefault(who, []).append(nums)
            print(json.dumps({"seed": seed, "who": who, **nums}), flush=True)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - tic,
                          "check_s": check_s}), flush=True)
        del loop
        torch.cuda.empty_cache()
    summary = {}
    for name in readings["program"][0]:
        row = {"lower": max(r[name] for r in readings["program"])}
        for who, rs in readings.items():
            if who != "program":
                row[who] = min(r[name] for r in rs)
        summary[name] = row
    print(json.dumps({"workload": args.workload, "card": device.power_limit(),
                      "summary": summary}), flush=True)
    if control:
        limits = propose(summary, loop_cls.training)
        print(json.dumps({"proposed_limits": limits}), flush=True)


if __name__ == "__main__":
    main()
