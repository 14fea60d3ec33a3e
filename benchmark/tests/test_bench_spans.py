"""The program's spans and counters on a device trace (spans.py) and the
readers of the program's metrics, on hand-built events and snapshots."""

from __future__ import annotations

import pytest

from benchmark import spans, spec, trace

PROGRAM_METRICS = ("batch_ms_per_step.sample", "idle_in_batch_pct.sample",
                   "pinned_mb_per_step.sample", "flat_ms_per_step.sample",
                   "upload_ms_per_pass.predict", "h2d_gb_per_pass.predict",
                   "draw_ms_per_pass.predict", "host_syncs_per_pass.predict")
READERS = {name: spec.load_reader(spec.ROOT / "benchmark" / "metrics"
                                  / f"{name}.py")
           for name in PROGRAM_METRICS}
BASE_NS = 1_700_000_000_000_000_000


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def snapshot(rows, counters=None):
    """A recorder snapshot of spans (name, start_us, end_us, parent, id) on
    the trace's timeline (microseconds from BASE_NS)."""
    return {"clock": "time_ns", "counters": counters or {}, "launches": {},
            "spans": [{"name": n, "start_ns": BASE_NS + int(a * 1e3),
                       "end_ns": None if b is None
                       else BASE_NS + int(b * 1e3), "parent": p, "id": i}
                      for n, a, b, p, i in rows]}


def traced(events, rows, counters=None, span_s=None):
    """A device-profile Trace of `events` carrying the program of `rows`."""
    tr = trace.Trace(events, span_s=span_s)
    tr.program = spans.Program(snapshot(rows, counters), events, BASE_NS)
    return tr


# one sampling step: the epoch gathers a batch (1000-1300 us), the step
# copies it (1300-1400) and runs (1300-2000), its update 1800-1900
STEP_ROWS = [("epoch", 900, 2100, None, 0),
             ("loader.gather", 1000, 1300, 0, None),
             ("step", 1300, 2000, 0, 5),
             ("to_device", 1300, 1400, 2, None),
             ("forward", 1400, 1600, 2, None),
             ("forward.cast", 1400, 1450, 4, None),
             ("update", 1800, 1900, 2, None),
             ("lr_vec", 1350, 1360, 3, None)]  # a stray child of to_device
STEP_EVENTS = [
    ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 1420, 30, 1),
    ev("cudaMemcpyAsync", "cuda_runtime", 1390, 5, 1),
    ev("elementwise_kernel", "kernel", 1460, 20, 2),   # the cast
    ev("cudaLaunchKernel", "cuda_runtime", 1420, 5, 2),
    ev("gemm", "kernel", 1500, 200, 3),                # the forward
    ev("cudaLaunchKernel", "cuda_runtime", 1500, 5, 3),
    ev("gemm_bwd", "kernel", 1700, 100, 4),            # the backward
    ev("cudaLaunchKernel", "cuda_runtime", 1650, 5, 4),
    ev("void csghmc_update_kernel<true>", "kernel", 1900, 80, 5),
    ev("cudaLaunchKernel", "cuda_runtime", 1850, 5, 5),
    ev("reduce_kernel", "kernel", 2050, 10, 6),        # no launch event
]


def test_spans_and_launches_are_placed_on_the_traces_axis():
    tr = traced(STEP_EVENTS, STEP_ROWS, span_s=1e-3)
    prog = spans.program_of(tr)
    # the axis counts from the first device event, at 1420 us
    assert prog.spans[0][1] == pytest.approx((900 - 1420) * 1e-6)
    name, cat, launch, a, b = prog.kernels[0]
    assert (name, cat) == ("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy")
    assert (launch, a, b) == pytest.approx(((1390 - 1420) * 1e-6, 0.0,
                                            30e-6))
    assert prog.kernels[-1][2] is None


def test_a_kernel_belongs_to_the_innermost_span_at_its_launch():
    prog = spans.program_of(traced(STEP_EVENTS, STEP_ROWS, span_s=1e-3))
    at = [prog.spans[prog.innermost(k[2])][0] if k[2] is not None else None
          for k in prog.kernels]
    assert at == ["to_device", "forward.cast", "forward", "step", "update",
                  None]
    assert prog.kernel_s(("update",), under="step") == pytest.approx(80e-6)
    assert prog.kernel_s(("forward",)) == pytest.approx(220e-6)
    assert prog.kernel_s(("epoch",)) == pytest.approx(400e-6)
    assert prog.kernel_s(("to_device",), keep=lambda n, c: True) \
        == pytest.approx(30e-6)
    assert prog.launched_in("csghmc_update", "update") == (1, 1)
    assert prog.launched_in("reduce", "epoch") == (0, 1)


def test_idle_time_goes_to_the_innermost_open_span():
    # busy 1420-1450 (the copy), 1460-1480, 1500-1800, 1900-1980 and
    # 2050-2060 us of a window of 700 us from the first device event
    tr = traced(STEP_EVENTS, STEP_ROWS, span_s=700e-6)
    prog = spans.program_of(tr)
    idle = prog.idle_by_span(tr)
    assert sum(idle.values()) == pytest.approx(tr.span_s - tr.busy_s())
    # the gaps 1450-1460 and 1480-1500 in the forward (its cast ended at
    # 1450), 1800-1900 in the update, 1980-2000 in the step, 2000-2100 less
    # the reduce's 10 in the epoch, 2100-2120 in none
    assert idle == pytest.approx({"forward": 30e-6, "update": 100e-6,
                                  "step": 20e-6, "epoch": 90e-6,
                                  spans.NO_SPAN: 20e-6})
    assert prog.idle_below(tr, "epoch") == pytest.approx(150e-6)


def test_idle_before_the_first_device_event_goes_to_its_span():
    """A window opened 300 us before its first device event: the Trace
    counts that idle stretch at the window's end; the program puts it where
    it was, inside the gather that ran then."""
    rows = [("epoch", 0, 1000, None, 0),
            ("loader.gather", 0, 300, 0, None),
            ("step", 300, 1000, 0, 0)]
    events = [ev("gemm", "kernel", 300, 600, 1),
              ev("cudaLaunchKernel", "cuda_runtime", 310, 5, 1)]
    tr = trace.Trace(events, span_s=1e-3)
    prog = spans.Program(snapshot(rows), events, BASE_NS,
                         window_ns=BASE_NS)
    tr.program = prog
    assert prog.window_start == pytest.approx(-300e-6)
    idle = prog.idle_by_span(tr)
    assert sum(idle.values()) == pytest.approx(tr.span_s - tr.busy_s())
    # 0-300 us in the gather, 900-1000 in the step
    assert idle == pytest.approx({"loader.gather": 300e-6, "step": 100e-6})
    ctx = {"trace": tr, "traffic": {"loop": "sample"}, "traced": {"steps": 1}}
    assert READERS["idle_in_batch_pct.sample"](ctx) == pytest.approx(75.0)


def test_sample_readers():
    tr = traced(STEP_EVENTS, STEP_ROWS,
                counters={"pinned_bytes": {"batch": 3_000_000},
                          "to_device_bytes": {"batch": 3_000_000}},
                span_s=700e-6)
    ctx = {"trace": tr, "traffic": {"loop": "sample"},
           "traced": {"steps": 2}}
    # the gather 300 us and the step's copy 100 us, over 2 steps
    assert READERS["batch_ms_per_step.sample"](ctx) == pytest.approx(0.2)
    assert READERS["pinned_mb_per_step.sample"](ctx) == pytest.approx(1.5)
    # the cast's 20 us and the update's 80 us; lr_vec launched nothing
    assert READERS["flat_ms_per_step.sample"](ctx) == pytest.approx(0.05)
    prog = spans.program_of(tr)
    idle = prog.idle_by_span(tr)
    want = 100 * (idle.get("to_device", 0) + idle.get("loader.gather", 0)) \
        / sum(idle.values())
    assert READERS["idle_in_batch_pct.sample"](ctx) == pytest.approx(want)


def test_idle_in_the_batch_path():
    """The card idle through the whole gather and copy: the share of idle
    time spent there."""
    rows = [("epoch", 0, 1000, None, 0),
            ("loader.gather", 0, 300, 0, None),
            ("step", 300, 1000, 0, 0),
            ("to_device", 300, 400, 2, None)]
    events = [ev("gemm", "kernel", 400, 500, 1),
              ev("cudaLaunchKernel", "cuda_runtime", 410, 5, 1)]
    tr = traced(events, rows, span_s=1e-3)
    # idle 900-1400 us: 900-1000 in the step, the rest in no span
    ctx = {"trace": tr, "traffic": {"loop": "sample"}, "traced": {"steps": 1}}
    assert READERS["idle_in_batch_pct.sample"](ctx) == pytest.approx(0.0)
    rows[0] = ("epoch", 0, 2000, None, 0)
    rows.append(("loader.gather", 1000, 1500, 0, None))
    tr = traced(events, rows, span_s=1.5e-3)
    # idle 900-1900: 900-1000 in the step, 1000-1500 in the gather,
    # 1500-1900 in the epoch
    ctx["trace"] = tr
    assert READERS["idle_in_batch_pct.sample"](ctx) == pytest.approx(50.0)


def test_predict_readers():
    rows = [("predict.pass", 0, 1000, None, 0),
            ("predict.upload", 0, 200, 0, None),
            ("predict.batch", 200, 1000, 0, [0, 0]),
            ("predict.draw", 200, 250, 2, None),
            ("forward", 250, 600, 2, None),
            ("predict.draw", 600, 650, 2, None),
            ("predict.readback", 650, 900, 2, None)]
    events = [ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 100, 90, 1),
              ev("cudaMemcpyAsync", "cuda_runtime", 50, 5, 1),
              ev("elementwise_kernel", "kernel", 230, 40, 2),
              ev("cudaLaunchKernel", "cuda_runtime", 210, 5, 2),
              ev("gemm", "kernel", 300, 200, 3),
              ev("cudaLaunchKernel", "cuda_runtime", 260, 5, 3),
              ev("vectorized_elementwise_kernel", "kernel", 620, 60, 4),
              ev("cudaLaunchKernel", "cuda_runtime", 610, 5, 4)]
    tr = traced(events, rows, span_s=1e-3,
                counters={"to_device_bytes": {"component": 6e9,
                                              "batch": 2e9},
                          "host_syncs": {"predict": 232}})
    ctx = {"trace": tr, "traffic": {"loop": "predict"},
           "traced": {"passes": 2}}
    assert READERS["upload_ms_per_pass.predict"](ctx) == pytest.approx(0.1)
    assert READERS["h2d_gb_per_pass.predict"](ctx) == pytest.approx(4.0)
    assert READERS["draw_ms_per_pass.predict"](ctx) == pytest.approx(0.05)
    assert READERS["host_syncs_per_pass.predict"](ctx) == pytest.approx(116)


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_readers_give_none_without_program_spans(name):
    kind = name.rsplit(".", 1)[1]
    other = "predict" if kind == "sample" else "sample"
    units = {"steps": 2, "passes": 2}
    events = [ev("gemm", "kernel", 0, 100, 1),
              ev("cudaLaunchKernel", "cuda_runtime", 0, 5, 1)]
    bare = trace.Trace(events, span_s=1e-3)  # as trace.record makes it
    assert READERS[name]({"trace": bare, "traffic": {"loop": kind},
                          "traced": units}) is None
    bare.program = None  # spans.record on a program with no recorder
    assert READERS[name]({"trace": bare, "traffic": {"loop": kind},
                          "traced": units}) is None
    tr = traced(events, [("epoch", 0, 200, None, 0)],
                counters={"host_syncs": {"epoch": 2}}, span_s=1e-3)
    assert READERS[name]({"trace": tr, "traffic": {"loop": other},
                          "traced": units}) is None


def test_the_recorder_is_found_and_its_snapshot_read():
    rec = spans.recorder()
    assert rec is not None
    was = rec.enable(True)
    rec.reset()
    try:
        with rec.span("epoch", 0):
            with rec.span("step", 0):
                rec.count("pinned_bytes", 7, "batch")
        snap = rec.snapshot()
    finally:
        rec.enable(was)
        rec.reset()
    base = snap["spans"][0]["start_ns"] - 1_000_000
    prog = spans.Program(snap, [], base)
    (_, a, b, _, _), (_, c, d, p, i) = prog.spans
    assert a <= c <= d <= b and p == 0 and i == 0
    assert prog.counter("pinned_bytes") == 7


def test_recording_holds_the_snapshot_and_leaves_the_recorder_as_it_was():
    rec = spans.recorder()
    assert not rec.recording()
    with spans.recording() as held:
        assert rec.recording() and held["window_ns"] > 0
        with rec.span("epoch", 3):
            rec.host_sync("epoch")
    assert not rec.recording() and rec.snapshot()["spans"] == []
    assert [s["name"] for s in held["snap"]["spans"]] == ["epoch"]
    assert held["snap"]["counters"] == {"host_syncs": {"epoch": 1}}
    doc = {"traceEvents": [], "baseTimeNanoseconds": held["window_ns"]}
    prog = spans.program(held, doc)
    assert prog.counter("host_syncs") == 1 and prog.spans[0][4] == 3


def test_recording_without_a_recorder_holds_nothing(monkeypatch):
    monkeypatch.setattr(spans, "recorder", lambda: None)
    with spans.recording() as held:
        pass
    assert held == {}
    assert spans.program(held, {"traceEvents": []}) is None
