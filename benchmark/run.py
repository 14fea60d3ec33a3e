"""Run one cell of the benchmark on the card and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the repository's root.  The cell's entry in BENCHMARK.json names its
configuration and traffic mix (spec.py); the mix's `loop` names the
generator that drives it (loops/<loop>.py).  The run:
  1. checks for the cards the cell asks for, and stops without a result
     where they are missing;
  2. sets up (process start to the first timed step: `setup_s`);
  3. measures the window on the host clock (the cell's end-to-end rate);
  4. with --trace 1, profiles a fixed piece of further work and reads the
     cell's per-layer metrics from it (metrics/<name>.py);
  5. reads the peak device memory, frees the program's state and compares
     what the timed path produced with the reference;
  6. stops without a result if JAX or the JAX package was loaded;
  7. prints each compared number beside its limit on standard error and,
     as the last line of standard output, one JSON object.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import compare, constants, device, loops, spec  # noqa: E402


def per_layer(cell, loop, units: dict, tr) -> dict:
    ctx = {"config": cell.config, "traffic": cell.traffic,
           "dim": loop.layout.dim, "traced": units, "trace": tr,
           "constants": constants}
    out = {}
    for m in cell.per_layer:
        value = cell.readers[m["name"]](ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, traced: bool,
        root=spec.ROOT, dev: str = "cuda", t0: float = T0) -> dict:
    """The result of one run as a dict (the last line's object); on a
    device other than a card the per-layer metrics and the device entry
    are left out, which only the CPU tests ask for."""
    import torch
    cell = spec.load_cell(workload, root)
    on_card = dev == "cuda"
    if on_card:
        device.require_chips(cell.chips)
    loop = loops.load(cell.traffic["loop"])(cell, seed, dev)
    loop.setup()
    setup_s = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    window = loop.window(seconds)
    unit = {m["name"]: m["unit"] for m in cell.end_to_end}
    metrics = {loop.metric: {"value": window["rate"],
                             "unit": unit[loop.metric]},
               "setup_s": {"value": setup_s, "unit": unit["setup_s"]}}
    result = {"correct": False, "attempted": window["attempted"],
              "failed": window["failed"]}
    if traced:
        units, tr = loop.traced()
        if tr.busy_s() <= 0:
            raise SystemExit("the profiler recorded no device time")
        metrics = per_layer(cell, loop, units, tr)
        result["breakdown"] = tr.breakdown()
        busy, span = tr.busy_s(), tr.span_s
    if on_card:
        peak = max(torch.cuda.max_memory_allocated(i)
                   for i in range(cell.chips))
        result["device"] = device.info(cell.chips, peak)
        if traced:
            result["device"].update(busy_s=busy, window_s=span)
    loop.free()
    t_check = time.perf_counter()
    checked = loop.check()
    result["timing"] = {"setup_s": setup_s, "window_s": window["seconds"],
                        "check_s": time.perf_counter() - t_check}
    ok, lines = compare.judge(checked["numbers"], cell.limits)
    result.update(correct=bool(ok and window["failed"] == 0),
                  metrics=metrics, checks=lines)
    # the compared numbers come last in the line
    result["checks"] = result.pop("checks")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    device.set_cache_dirs(ROOT)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = device.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        raise SystemExit(1)
    print(f"card: {device.power_limit()}; seconds: "
          f"{json.dumps(result.pop('timing'))}", file=sys.stderr)
    for name, line in result["checks"].items():
        print(f"check {name} = {line['value']!r} (limit {line['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    # nothing is left to flush or stop: skip freeing tens of GB of host
    # arrays one by one at interpreter exit
    os._exit(0)


if __name__ == "__main__":
    main()
