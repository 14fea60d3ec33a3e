"""The traced window: `torch.profiler` over a piece of work, read back from
its Chrome trace into device intervals and host operations.

Two profiles, so that the numbers are not the profiler's own cost:
  * the device profile records the card's activity alone (CUDA, no host
    operators), over the work between two synchronisations.  Its window
    is timed by a pair of CUDA events around the work, and the card is
    busy where any kernel, copy or memset runs: the union of their
    intervals, not the sum.  Every per-layer metric reads this one;
  * the host profile records host operators and the card's activity over
    a shorter piece of like work (its window the annotation
    `bench_window`).  It names the idle gaps of the breakdown: each by the
    innermost host operation that was running at the gap's middle.  Host
    recording slows a host-bound loop, so no metric reads its times.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, List, Optional, Tuple

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 100
# a gap during which the host ran no operator: Python code between them
NO_OP = "host outside any aten op"


class Trace:
    """Intervals in seconds from the window's start.  The window is the
    `bench_window` annotation's, or, where `span_s` is given, that long (a
    device profile, whose events all lie inside the window; its intervals
    count from the first device event)."""

    def __init__(self, events: list, span_s: Optional[float] = None):
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        if span_s is None:
            win = next(e for e in events if e.get("name") == WINDOW
                       and e.get("cat") == "user_annotation")
            t0, t1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
        else:  # nothing to clip: every device event lies in the window
            t0 = min((float(e["ts"]) for e in dev), default=0.0)
            t1 = max((float(e["ts"]) + float(e.get("dur", 0.0))
                      for e in dev), default=0.0)
        self.span_s = (t1 - t0) * 1e-6 if span_s is None else span_s
        self.host_gaps: Optional[dict] = None

        def clip(e):
            a = max(float(e["ts"]), t0)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), t1)
            return (a - t0) * 1e-6, (b - t0) * 1e-6

        self.device: List[Tuple[str, str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X" or cat not in DEVICE_CATS + ("cpu_op",):
                continue
            a, b = clip(e)
            if b <= a:
                continue
            if cat == "cpu_op":
                self.host.append((e["name"], a, b))
            else:
                self.device.append((e["name"], cat, a, b))

    def busy_intervals(self):
        merged = []
        for _, _, a, b in sorted(self.device, key=lambda d: d[2]):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def time_by_name(self, keep: Callable[[str, str], bool] = None) -> dict:
        """Device seconds summed by name, over the events `keep(name, cat)`
        admits."""
        out = defaultdict(float)
        for name, cat, a, b in self.device:
            if keep is None or keep(name, cat):
                out[name] += b - a
        return dict(out)

    def durations(self, keep: Callable[[str, str], bool]) -> List[float]:
        return [b - a for name, cat, a, b in self.device if keep(name, cat)]

    def idle_by_host_op(self) -> dict:
        """Idle seconds inside the window, by the host operation running at
        each gap's middle."""
        gaps, prev = [], 0.0
        for a, b in self.busy_intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if prev < self.span_s:
            gaps.append((prev, self.span_s))
        hosts = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in hosts]
        out = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            out[self._host_at(hosts, starts, mid)] += b - a
        return dict(out)

    @staticmethod
    def _host_at(hosts, starts, t, look_back: int = 256) -> str:
        """The latest-starting host op that runs at t, among the
        `look_back` that started last before it."""
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(-1, i - 1 - look_back), -1):
            if hosts[j][2] >= t:
                return hosts[j][0]
        return NO_OP

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing (from the host profile where one
        was recorded)."""
        def top(d):
            return [[k[:NAME_CHARS], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        gaps = self.host_gaps if self.host_gaps is not None \
            else self.idle_by_host_op()
        return {"device_ops": top(self.time_by_name()),
                "idle_gaps": top(gaps)}


def _events(prof) -> list:
    """The profile's Chrome trace events, through a file in the temporary
    directory that is deleted once read."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def record(work: Callable[[], object],
           host_work: Optional[Callable[[], object]] = None) -> Trace:
    """The Trace of `work` under the device profile, the card synchronised
    before and after it; with `host_work`, its idle gaps named from the
    host profile of `host_work`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start.record()
        work()
        end.record()
        torch.cuda.synchronize()
    tr = Trace(_events(prof), span_s=start.elapsed_time(end) * 1e-3)
    if host_work is not None:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                host_work()
                torch.cuda.synchronize()
        tr.host_gaps = Trace(_events(prof)).idle_by_host_op()
    return tr
