"""Whether the recorder's clock is the profiler's, on the card.

    python3 benchmark/clock_probe.py

from the repository's root.  Under a CUDA-only and then a CPU+CUDA
`torch.profiler` profile it launches 30 matrix products, each between two
`time.time_ns()` readings, and exports the Chrome trace.  It prints, for
each profile: the event categories; how many of the 30 pairs of readings
hold a launch call (`cuda_runtime` or `cuda_driver`), placed at
`ts * 1e3 + baseTimeNanoseconds`, which is how the recorder's spans are
placed; how far the nearest launch lies after the first reading and before
the second, in microseconds; and how many kernel events have a launch call
of the same `correlation`.
"""

import collections
import json
import os
import statistics
import sys
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile


def main():
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    x = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    for acts in ([ProfilerActivity.CUDA],
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        marks = []
        with profile(activities=acts) as prof:
            for _ in range(30):
                a = time.time_ns()
                x @ x
                b = time.time_ns()
                marks.append((a, b))
                time.sleep(0.002)
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                doc = json.load(f)
        finally:
            os.remove(path)
        ev = doc["traceEvents"]
        base = doc.get("baseTimeNanoseconds") or 0
        cats = collections.Counter(e.get("cat") for e in ev)
        rt = sorted((e for e in ev if e.get("ph") == "X"
                     and e.get("cat") in ("cuda_runtime", "cuda_driver")
                     and "aunch" in e.get("name", "")),
                    key=lambda e: e["ts"])
        print([a.name for a in acts], "base", base, "cats", dict(cats),
              "launches", collections.Counter(e["name"] for e in rt),
              flush=True)
        ts_ns = [float(e["ts"]) * 1e3 + base for e in rt]
        inside, lead, tail = 0, [], []
        for a, b in marks:
            inside += any(a <= t <= b for t in ts_ns)
            near = min(ts_ns, key=lambda t: abs(t - a))
            lead.append((near - a) / 1e3)
            tail.append((b - near) / 1e3)
        print("pairs of readings with a launch inside", inside, "of",
              len(marks), "; launch - first reading, us: median",
              statistics.median(lead), "min", min(lead), "max", max(lead),
              "; second reading - launch, us: median",
              statistics.median(tail), "min", min(tail), flush=True)
        k = [e for e in ev if e.get("cat") == "kernel"]
        corr = {e.get("args", {}).get("correlation") for e in rt}
        print("kernels", len(k), "with a launch by correlation",
              sum(e.get("args", {}).get("correlation") in corr for e in k),
              flush=True)


if __name__ == "__main__":
    main()
