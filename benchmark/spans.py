"""The program's own spans and counters on the device trace's timeline.

The port records spans and counters where its work happens
(`bayesdll_tpu_torch/utils/profiling.py`: off unless turned on; host
timestamps on `time.time_ns()`, the clock of the profiler's Chrome trace
counted from its `baseTimeNanoseconds`).  `record` is `trace.record` with
that recorder on and reset around the device profile's work (`recording`):
the Trace it returns carries `program`, a `Program` of the snapshot placed
on the Trace's own time axis (seconds from its first device event), or None
where the program has no recorder (then `record` reads what `trace.record`
reads).
The readers `metrics/<name>.py` of the program's metrics return None where
a Trace carries no program.

A kernel or copy belongs to the span that was innermost open on the host
when it was launched: its launch call on the host (the `cuda_runtime` or
`cuda_driver` event of the same `correlation`) falls inside that span.
The card's idle time belongs to the span that was innermost open while the
card was idle.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Iterable, Optional

from benchmark import trace

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no span)"


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from bayesdll_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "snapshot") else None


class Program:
    """A recorder snapshot on a device profile's time axis.

    spans: [(name, start_s, end_s, parent, id)], parent an index or None;
    kernels: [(name, cat, launch_s or None, start_s, end_s)], every device
    event with its launch time where the profile has its launch call;
    counters: {name: {site: total}}; launches: the kernels' launch counts;
    window_start: when the profiled window opened (`window_ns`, the host's
    clock as the window's first CUDA event was recorded), or the first
    device event where that is not given.  The card was idle from there
    to its first event: a Trace puts that stretch at the window's end,
    where no span is open any more, and `idle_by_index` puts it back.
    """

    def __init__(self, snap: dict, events: list, base_ns: int = 0,
                 window_ns: Optional[int] = None):
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in trace.DEVICE_CATS]
        # the Trace's origin: its first device event
        t0 = min((float(e["ts"]) for e in dev), default=0.0)

        def sec(us):
            return (us - t0) * 1e-6

        launched = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launched[corr] = sec(float(e["ts"]))
        self.kernels = [
            (e["name"], e["cat"],
             launched.get((e.get("args") or {}).get("correlation")),
             sec(float(e["ts"])),
             sec(float(e["ts"]) + float(e.get("dur", 0.0)))) for e in dev]
        self.spans = [
            (s["name"], sec((s["start_ns"] - base_ns) / 1e3),
             None if s["end_ns"] is None
             else sec((s["end_ns"] - base_ns) / 1e3), s["parent"], s["id"])
            for s in snap["spans"]]
        self.window_start = 0.0 if window_ns is None \
            else min(0.0, sec((window_ns - base_ns) / 1e3))
        self.counters = snap.get("counters", {})
        self.launches = snap.get("launches", {})
        self._segments = self._innermost_segments()
        self._starts = [a for a, _, _ in self._segments]

    # ---- the span tree --------------------------------------------------

    def _innermost_segments(self):
        """[(start_s, end_s, span index)]: time cut where any closed span
        opens or closes, each piece under the innermost span open then
        (index -1 where none is)."""
        marks = []
        for i, (_, a, b, _, _) in enumerate(self.spans):
            if b is not None:
                marks += [(a, 1, i), (b, 0, -i)]
        marks.sort()  # at one time, ends before starts, inner ends first
        out, stack, prev = [], [], None
        for t, opens, k in marks:
            if prev is not None and t > prev:
                out.append((prev, t, stack[-1] if stack else -1))
            prev = t
            if opens:
                stack.append(k)
            elif stack and stack[-1] == -k:
                stack.pop()
            elif -k in stack:
                stack.remove(-k)
        return out

    def innermost(self, t: float) -> int:
        """The index of the innermost span open at t, or -1."""
        j = bisect.bisect_right(self._starts, t) - 1
        if j < 0 or t >= self._segments[j][1]:
            return -1
        return self._segments[j][2]

    def nearest(self, i: int, names: Iterable[str]) -> int:
        """The nearest of span i and its ancestors named in `names`, or
        -1."""
        names = set(names)
        while i is not None and i >= 0:
            if self.spans[i][0] in names:
                return i
            i = self.spans[i][3]
        return -1

    def within(self, i: int, name: str) -> bool:
        """Whether span i or an ancestor is named `name`."""
        return self.nearest(i, (name,)) >= 0

    # ---- readings ---------------------------------------------------------

    def host_s(self, names: Iterable[str], under: Optional[str] = None
               ) -> float:
        """Host seconds in the closed spans named in `names` (those inside
        a span named `under`, where given)."""
        names = set(names)
        return sum(b - a for i, (n, a, b, p, _) in enumerate(self.spans)
                   if n in names and b is not None
                   and (under is None or (p is not None
                                          and self.within(p, under))))

    def kernel_s(self, names: Iterable[str], under: Optional[str] = None,
                 keep: Callable[[str, str], bool] = None) -> float:
        """Device seconds of the device events `keep(name, cat)` admits
        (kernels by default) launched inside a span named in `names` (the
        nearest such, itself inside a span named `under` where given)."""
        keep = keep or (lambda name, cat: cat == "kernel")
        total = 0.0
        for name, cat, launch, a, b in self.kernels:
            if launch is None or not keep(name, cat):
                continue
            i = self.nearest(self.innermost(launch), names)
            if i >= 0 and (under is None or self.within(i, under)):
                total += b - a
        return total

    def launched_in(self, kernel: str, name: str):
        """(launches of kernels whose name holds `kernel` that fall inside
        a span named `name`, all such launches in the profile)."""
        hits = [self.within(self.innermost(launch), name) if launch
                is not None else False
                for k, cat, launch, _, _ in self.kernels
                if cat == "kernel" and kernel in k]
        return sum(hits), len(hits)

    def _gaps(self, tr: trace.Trace):
        """The card's idle intervals in the Trace's window, which opens at
        window_start and lasts tr.span_s."""
        gaps, prev = [], self.window_start
        end = self.window_start + tr.span_s
        for a, b in tr.busy_intervals():
            if a > prev:
                gaps.append((prev, min(a, end)))
            prev = max(prev, b)
        if prev < end:
            gaps.append((prev, end))
        return [(a, b) for a, b in gaps if b > a]

    def idle_by_index(self, tr: trace.Trace) -> dict:
        """The card's idle seconds in the Trace's window, by the index of
        the innermost span open while it was idle (-1 where none was)."""
        out = defaultdict(float)
        segs = self._segments
        for a, b in self._gaps(tr):
            covered = 0.0
            j = max(0, bisect.bisect_right(self._starts, a) - 1)
            while j < len(segs) and segs[j][0] < b:
                s0, s1, i = segs[j]
                part = min(b, s1) - max(a, s0)
                if part > 0:
                    out[i] += part
                    covered += part
                j += 1
            if b - a - covered > 1e-12:  # more than the sums' rounding
                out[-1] += b - a - covered
        return dict(out)

    def idle_by_span(self, tr: trace.Trace) -> dict:
        """idle_by_index by span name (NO_SPAN for -1)."""
        out = defaultdict(float)
        for i, sec in self.idle_by_index(tr).items():
            out[self.spans[i][0] if i >= 0 else NO_SPAN] += sec
        return dict(out)

    def idle_below(self, tr: trace.Trace, name: str) -> float:
        """Idle seconds while the innermost open span lay inside a span
        named `name` (not that span itself)."""
        return sum(sec for i, sec in self.idle_by_index(tr).items()
                   if i >= 0 and self.spans[i][0] != name
                   and self.within(i, name))

    def counter(self, name: str) -> int:
        """A counter's total over its sites."""
        return sum(self.counters.get(name, {}).values())


def program_of(tr) -> Optional[Program]:
    """The Trace's program, or None (a Trace of a program that has no
    recorder, or one that `trace.record` made)."""
    return getattr(tr, "program", None)


@contextlib.contextmanager
def recording():
    """The program's recorder on and reset for the block.  Yields a dict
    that holds the window's host start (`window_ns`) and, once the block
    has run, the recorder's `snap`; it stays empty where the program has
    no recorder.  The recorder is as it was, and empty, after."""
    rec, held = recorder(), {}
    if rec is None:
        yield held
        return
    was = rec.enable(True)
    rec.reset()
    try:
        held["window_ns"] = time.time_ns()
        yield held
        held["snap"] = rec.snapshot()
    finally:
        rec.enable(was)
        rec.reset()


def program(held: dict, doc: dict) -> Optional[Program]:
    """The Program of what `recording` held, on the Chrome trace `doc`'s
    axis; None where it held no snapshot."""
    if "snap" not in held:
        return None
    return Program(held["snap"], doc["traceEvents"],
                   int(doc.get("baseTimeNanoseconds", 0)), held["window_ns"])


def _document(prof) -> dict:
    """`trace._events`, but the whole Chrome trace: its events and its
    `baseTimeNanoseconds`."""
    fd, path = tempfile.mkstemp(suffix=".pt.trace.json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def record(work: Callable[[], object],
           host_work: Optional[Callable[[], object]] = None) -> trace.Trace:
    """`trace.record` with the program's recorder on around `work` under
    the device profile: the Trace's `program` is the recorder's snapshot on
    its time axis, or None where the program has no recorder.  This is
    `trace.record`'s body with the two lines marked `program` added and
    `_document` read in place of `_events`, written to replace it verbatim
    once the benchmark reads the program's metrics; until then
    `span_probe.py` calls it in `trace.record`'s place."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with recording() as held:  # program
            start.record()
            work()
            end.record()
            torch.cuda.synchronize()
    doc = _document(prof)
    tr = trace.Trace(doc["traceEvents"], span_s=start.elapsed_time(end) * 1e-3)
    tr.program = program(held, doc)  # program
    if host_work is not None:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW):
                host_work()
                torch.cuda.synchronize()
        tr.host_gaps = trace.Trace(trace._events(prof)).idle_by_host_op()
    return tr
