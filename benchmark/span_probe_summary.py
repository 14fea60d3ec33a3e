"""Prints the main readings of span_probe.py's result files.

    python3 benchmark/span_probe_summary.py ["build/span_probe/*.json"]

One block a file: the recorder's call costs, the paired units off and on,
and for each traced run its units, busy and window seconds, per-layer
metrics and, with the recorder on, its program shares, idle seconds by
span (the largest twelve), host milliseconds a unit by span, counters and
launch counts.
"""

import glob
import json
import statistics
import sys


def main(pattern: str):
    for path in sorted(glob.glob(pattern)):
        with open(path) as f:
            r = json.load(f)
        print("==", path, r["card"])
        print(" calls", {k: round(v, 1) for k, v in r["calls"].items()})
        if "paired" in r:
            off, on = r["paired"]["off_s"], r["paired"]["on_s"]
            for tag, xs in (("off", off), ("on ", on)):
                print(f" paired {tag} ms", [round(x * 1e3, 3) for x in xs],
                      "median", round(statistics.median(xs) * 1e3, 3))
            print(" held a unit",
                  json.dumps(r["paired"]["held_per_step_or_pass"]))
        for tag in ("traced_off", "traced_on"):
            for t in r[tag]:
                print(" ", tag, "units", t["units"], "busy",
                      round(t["busy_s"], 4), "window", round(t["window_s"], 4))
                print("    metrics", json.dumps(
                    {k: round(v, 4) for k, v in t["metrics"].items()}))
                g = t.get("program")
                if g is None:
                    continue
                print("    program", json.dumps(
                    {k: v for k, v in g.items() if k not in (
                        "idle_by_span_s", "counters", "launches")}))
                print("    idle by span", json.dumps(
                    {k: round(v, 4) for k, v in
                     list(g["idle_by_span_s"].items())[:12]}))
                print("    host ms a unit", json.dumps(
                    {k: round(v, 3) for k, v in
                     g.get("host_ms_per_unit", {}).items()}))
                print("    counters", json.dumps(g["counters"]),
                      "launches", json.dumps(g["launches"]))
            if r[tag]:
                print("   breakdown (last)",
                      json.dumps(r[tag][-1]["breakdown"])[:1500])


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "build/span_probe/*.json")
