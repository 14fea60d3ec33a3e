"""The program's spans and counters on one cell, on the card: what they read
and what they cost.

    python3 benchmark/span_probe.py --workload <cell> --seed <n> \\
        [--pairs 6] [--traces 2] [--out build/span_probe]

from the repository's root.  It sets the cell up as run.py does, then
  1. times the recorder's own calls (a span entered and left, a counter)
     on and off, in nanoseconds on the host;
  2. runs whole epochs (or passes) in pairs, recorder off then on or on
     then off, each timed on the host clock: the recorder's cost end to
     end, and its spans and counters a unit;
  3. profiles the cell's traced work `--traces` times with the recorder
     off (`trace.record`, as run.py does) and as often with it on
     (`spans.record`), and reads the cell's per-layer metrics from each,
     the program's metrics (`PROGRAM_METRICS`) from the traces with it
     on, how many of the update kernel's launches fall inside an `update`
     span, and the card's idle time by innermost span;
and prints one JSON object as its last line (and writes it under --out).
Nothing it prints decides anything: it measures what a traced run of the
benchmark would read once the run's device profile carries the program's
spans.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import device, loops, run, spans, spec, trace  # noqa: E402

# the program's metrics: (name, unit, loop kind)
PROGRAM_METRICS = (
    ("batch_ms_per_step.sample", "ms", "sample"),
    ("idle_in_batch_pct.sample", "%", "sample"),
    ("pinned_mb_per_step.sample", "MB", "sample"),
    ("flat_ms_per_step.sample", "ms", "sample"),
    ("upload_ms_per_pass.predict", "ms", "predict"),
    ("h2d_gb_per_pass.predict", "GB", "predict"),
    ("draw_ms_per_pass.predict", "ms", "predict"),
    ("host_syncs_per_pass.predict", "count", "predict"),
)
CALLS = 200_000


def call_ns(profiling) -> dict:
    """Host nanoseconds of one span entered and left, and of one count,
    with the recorder off and on."""
    out = {}
    for on in (False, True):
        was = profiling.enable(on)
        profiling.reset()
        t0 = time.perf_counter_ns()
        for _ in range(CALLS):
            with profiling.span("probe"):
                pass
        t1 = time.perf_counter_ns()
        for _ in range(CALLS):
            profiling.count("probe", 1, "site")
        t2 = time.perf_counter_ns()
        profiling.enable(was)
        profiling.reset()
        tag = "on" if on else "off"
        out[f"span_ns_{tag}"] = (t1 - t0) / CALLS
        out[f"count_ns_{tag}"] = (t2 - t1) / CALLS
    return out


def unit_work(loop):
    """(one unit of the cell's work, the units it holds): an epoch and its
    steps, or a pass and 1."""
    if loop.metric == "train_img_per_s":
        return loop._epoch, len(loop.loader)
    return (lambda: loop.runner.evaluate(loop.loader)), 1


def paired(loop, profiling, pairs: int) -> dict:
    """Host seconds a unit with the recorder off and on, in pairs whose
    order alternates; and what the recorder held after each unit on."""
    work, per = unit_work(loop)
    off, on, held = [], [], []
    for k in range(pairs):
        for state in ((False, True) if k % 2 == 0 else (True, False)):
            was = profiling.enable(state)
            profiling.reset()
            t0 = time.perf_counter()
            work()
            loop._sync()
            dt = (time.perf_counter() - t0) / per
            if state:
                snap = profiling.snapshot()
                held.append({"spans": len(snap["spans"]) / per,
                             "counters": snap["counters"]})
            profiling.enable(was)
            profiling.reset()
            (on if state else off).append(dt)
    return {"off_s": off, "on_s": on, "held_per_step_or_pass": held[-1]}


def readings(cell, loop, with_program: bool) -> dict:
    """One traced run's per-layer metrics (the cell's, and with the
    recorder on the program's), breakdown and program shares."""
    saved = trace.record
    if with_program:
        trace.record = spans.record
    try:
        units, tr = loop.traced()
    finally:
        trace.record = saved
    layer = list(cell.per_layer)
    readers = dict(cell.readers)
    kind = cell.traffic["loop"]
    if with_program:
        for name, unit, k in PROGRAM_METRICS:
            if k == kind:
                layer.append({"name": name, "unit": unit})
                readers[name] = spec.load_reader(
                    spec.ROOT / "benchmark" / "metrics" / f"{name}.py")
    probe_cell = dataclasses.replace(cell, per_layer=layer, readers=readers)
    out = {"units": units, "busy_s": tr.busy_s(), "window_s": tr.span_s,
           "metrics": {k: v["value"] for k, v in
                       run.per_layer(probe_cell, loop, units, tr).items()},
           "breakdown": tr.breakdown()}
    prog = spans.program_of(tr)
    if prog is not None:
        idle = prog.idle_by_span(tr)
        total = sum(idle.values())
        inside, launches = prog.launched_in("csghmc_update", "update")
        unattributed = sum(1 for _, cat, launch, _, _ in prog.kernels
                           if launch is None)
        out["program"] = {
            "csghmc_update_in_update": [inside, launches],
            "idle_s": total,
            "idle_below_epoch_pct": 100.0 * prog.idle_below(tr, "epoch")
            / total if total > 0 else None,
            "idle_below_pass_pct": 100.0 * prog.idle_below(
                tr, "predict.pass") / total if total > 0 else None,
            "idle_by_span_s": dict(sorted(idle.items(),
                                          key=lambda kv: -kv[1])),
            "device_events": len(prog.kernels),
            "device_events_without_launch": unattributed,
            "spans": len(prog.spans),
            "host_ms_per_unit": host_ms(prog, units),
            "counters": prog.counters, "launches": prog.launches}
    return out


def host_ms(prog, units) -> dict:
    """Host milliseconds a step (or pass) in each span name, and `step`'s
    self time (the backward and the dispatch) as `step.self`."""
    per = units.get("steps") or units.get("passes")
    out, inner = defaultdict(float), 0.0
    for name, a, b, parent, _ in prog.spans:
        if b is None:
            continue
        out[name] += b - a
        if parent is not None and prog.spans[parent][0] == "step":
            inner += b - a
    if "step" in out:
        out["step.self"] = out["step"] - inner
    return {k: 1e3 * v / per for k, v in sorted(out.items(),
                                                 key=lambda kv: -kv[1])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=6,
                    help="pairs of units timed off and on (0: none)")
    ap.add_argument("--traces", type=int, default=2)
    ap.add_argument("--out", default="build/span_probe")
    args = ap.parse_args(argv)
    device.set_cache_dirs(ROOT)
    from bayesdll_tpu_torch.utils import profiling
    cell = spec.load_cell(args.workload)
    device.require_chips(cell.chips)
    loop = loops.load(cell.traffic["loop"])(cell, args.seed, "cuda")
    loop.setup()
    result = {"workload": args.workload, "seed": args.seed,
              "card": device.power_limit(), "calls": call_ns(profiling)}
    if args.pairs:
        result["paired"] = paired(loop, profiling, args.pairs)
    result["traced_off"], result["traced_on"] = [], []
    for _ in range(args.traces):
        result["traced_off"].append(readings(cell, loop, False))
        result["traced_on"].append(readings(cell, loop, True))
    os.makedirs(args.out, exist_ok=True)
    path = Path(args.out) / f"{args.workload}.{args.seed}.json"
    path.write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    os._exit(0)


if __name__ == "__main__":
    main()
