"""Tracing (counterpart of bayesdll_tpu.utils.profiling).

The reference's only observability is coarse per-epoch wall clock
(reference `methods/sgld.py:88,104-113`).  Here:

  * the recorder: spans and counters that the program places where its
    work happens, off by default.  `span(name, id=None)` is a context
    manager that records the block's name, host start and end, its parent
    (the innermost span open on this thread) and an id shared by one unit
    of work (the global step, an epoch, a predictive pass or (pass, batch));
    `count(name, n, site)` adds n to a counter at a site, and
    `host_sync(site)` counts one blocking device-to-host read.  A span
    reads the host clock only: it never synchronises the card or reads a
    device value, so a loop that never waits still never waits; the device
    time of its work comes from a profile.  Off, `span` returns one shared
    no-op and `count` returns at the same single check: no allocation, no
    clock read, no torch call.  `enable`, `reset` and `snapshot` (the spans,
    the counters and ops/kernels.py's launch counts) drive it;
  * `trace(logdir)`: a context manager around `torch.profiler` that writes a
    TensorBoard-loadable trace (`<worker>.<time>.pt.trace.json`, with the
    card's kernels when CUDA is available) into `logdir`, the recorder on
    for the block, and its spans and counters beside it
    (`<worker>.<time>.program.json`) as Chrome-trace events of category
    "program" on the profiler's clock: the same `baseTimeNanoseconds`, so
    the two files' `ts` line up and their `traceEvents` concatenate into
    one trace.

The clock: a span's times are `time.time_ns()`.  The profiler's Chrome
trace gives its events' `ts` in microseconds from `baseTimeNanoseconds` on
the same clock (CLOCK_REALTIME), so `(t_ns - base) / 1e3` places a span on
that timeline (`to_trace_us`), with the host operators, the runtime's
launch calls and the card's kernels.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import socket
import threading
import time
from typing import Optional

import torch


# --- hardware and model constants ------------------------------------------

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit: bf16 on the tensor cores, and fp32 outside them
BF16_PEAK = 989e12
FP32_PEAK = 67e12

# Analytic forward FLOPs per example at 224^2 (the JAX package's constants)
# unless the entry says otherwise: convs/matmuls only, 2 FLOPs per MAC;
# training step = 3x forward.
FWD_FLOPS_PER_EXAMPLE = {
    "resnet101": 15.7e9,       # 7.85 GMACs (torchvision profile)
    "resnet50": 8.2e9,         # 4.09 GMACs
    "vit_l_32": 30.5e9,        # 2 * 305M params * 50 tokens
    "vit_b_16": 33.8e9,        # 2 * 86M params * 197 tokens
    # at 384^2: 115.38 GMACs (benchmark/swinv2_counts.py: the patch
    # convolution, the token-wise products, the attention cores, merges)
    "swinv2_l_w24_384": 230.8e9,
}


# --- the recorder ------------------------------------------------------------

_on = False
_spans: list = []      # every _Span entered since the last reset, in order
_counters: dict = {}   # (name, site) -> total
_count_lock = threading.Lock()
_open = threading.local()  # .stack: this thread's open spans


class _NoSpan:
    """The span of a recorder that is off: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


class _Span:
    __slots__ = ("name", "id", "start", "end", "parent")

    def __init__(self, name: str, id):
        self.name, self.id = name, id
        self.start = self.end = None

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        _spans.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        return False


def span(name: str, id=None):
    """A context manager that records the block as a span named `name`,
    with `id` the unit of work it belongs to; the shared no-op when the
    recorder is off."""
    if not _on:
        return _NO_SPAN
    return _Span(name, id)


def count(name: str, n=1, site: str = ""):
    """Adds n to the counter `name` at `site`; nothing when off."""
    if not _on:
        return
    key = (name, site)
    with _count_lock:
        _counters[key] = _counters.get(key, 0) + int(n)


def host_sync(site: str, n: int = 1):
    """Counts n blocking device-to-host reads at `site` (counter
    `host_syncs`).  The sites count on any device, so that the CPU counts
    what a card would wait for."""
    count("host_syncs", n, site)


def recording() -> bool:
    return _on


def enable(on: bool = True) -> bool:
    """Turns the recorder on or off; returns whether it was on."""
    global _on
    was, _on = _on, bool(on)
    return was


def reset():
    """Drops every recorded span and counter (spans open now are no longer
    anyone's parent)."""
    _spans.clear()
    _counters.clear()
    _stack().clear()


def snapshot() -> dict:
    """What the recorder holds: {"clock": "time_ns", "spans": [{name,
    start_ns, end_ns, parent, id}] in the order they opened (parent an
    index into the list, or None; end_ns None while open), "counters":
    {name: {site: total}}, "launches": ops/kernels.py's launch counts}."""
    from bayesdll_tpu_torch.ops import kernels
    index = {id(s): i for i, s in enumerate(_spans)}
    spans = [{"name": s.name, "start_ns": s.start, "end_ns": s.end,
              "parent": index.get(id(s.parent)) if s.parent else None,
              "id": s.id} for s in _spans]
    counters: dict = {}
    for (name, site), n in _counters.items():
        counters.setdefault(name, {})[site] = n
    return {"clock": "time_ns", "spans": spans, "counters": counters,
            "launches": kernels.launch_counts()}


def to_trace_us(t_ns: int, base_ns: int) -> float:
    """A recorder time on a profiler Chrome trace's timeline (microseconds
    from its `baseTimeNanoseconds`)."""
    return (t_ns - base_ns) / 1e3


def chrome_events(snap: dict, base_ns: int = 0, pid=None) -> list:
    """The snapshot as Chrome-trace events of category "program" on a trace
    whose `baseTimeNanoseconds` is base_ns: each closed span a complete
    event ("X") on the thread row "program spans", its id and parent in
    `args`; each counter one counter event ("C") at the last span's end,
    its sites as series."""
    pid = os.getpid() if pid is None else pid
    tid = "program spans"
    out, last = [], None
    for i, s in enumerate(snap["spans"]):
        if s["end_ns"] is None:
            continue
        out.append({"ph": "X", "cat": "program", "name": s["name"],
                    "pid": pid, "tid": tid,
                    "ts": to_trace_us(s["start_ns"], base_ns),
                    "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                    "args": {"index": i, "parent": s["parent"],
                             "id": s["id"]}})
        last = s["end_ns"] if last is None else max(last, s["end_ns"])
    ts = to_trace_us(last if last is not None else time.time_ns(), base_ns)
    for name, sites in sorted(snap["counters"].items()):
        out.append({"ph": "C", "cat": "program", "name": name, "pid": pid,
                    "ts": ts, "args": {k or "all": v
                                       for k, v in sorted(sites.items())}})
    return out


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profiler trace of the block into `logdir`; no-op when logdir is None.
    It records the host's ops, and the card's kernels when CUDA is
    available; the recorder is on for the block, and its spans and
    counters go into a file beside the trace (`chrome_events`)."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    was = enable(True)
    reset()
    try:
        with prof:
            yield
    finally:
        snap = snapshot()
        enable(was)
        reset()
        _export(prof, snap, logdir)


_BASE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


def _base_ns(path: str) -> int:
    """The Chrome trace's `baseTimeNanoseconds`, read from the file's head or
    tail (the profiler writes it before or after the events), without
    parsing the events; 0 where it has none."""
    with open(path, "rb") as f:
        head = f.read(1 << 20)
        f.seek(max(0, os.path.getsize(path) - (1 << 16)))
        tail = f.read()
    m = _BASE.search(head) or _BASE.search(tail)
    return int(m.group(1)) if m else 0


def _export(prof, snap: dict, logdir: str):
    """The profile's Chrome trace as `<worker>.<time>.pt.trace.json` in
    logdir (TensorBoard's name), and the snapshot's events beside it as
    `<worker>.<time>.program.json`, on the trace's `baseTimeNanoseconds`."""
    os.makedirs(logdir, exist_ok=True)
    stem = os.path.join(logdir, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}")
    prof.export_chrome_trace(stem + ".pt.trace.json")
    base = _base_ns(stem + ".pt.trace.json")
    with open(stem + ".program.json", "w") as f:
        json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base,
                   "traceEvents": chrome_events(snap, base)}, f)
