"""The port's recorder (utils/profiling.py): spans and counters off by
default and free when off; on, the span tree, ids and counters of a cSGHMC
epoch, a cycle end, the fused path and the predictive passes, each
counter at the value the code implies; the span clock against
torch.profiler's Chrome trace; the sampler entry points' `update` spans;
and the Chrome-trace events that `trace(logdir)` writes."""

import collections
import json
import tracemalloc

import numpy as np
import pytest
import torch

from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.data import ArrayLoader
from bayesdll_tpu_torch.data.stream import window_batches
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.models import create_backbone
from bayesdll_tpu_torch.ops import fused, kernels
from bayesdll_tpu_torch.utils import profiling
from tests.test_torch_multichain_runner import build, one_thread  # noqa: F401

HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.01", "thin": "2",
      "bias": "informative", "nst": "2", "momentum_decay": "0.05"}


@pytest.fixture
def recording():
    """The recorder on and empty for the test, off and empty after."""
    was = profiling.enable(True)
    profiling.reset()
    yield
    profiling.enable(was)
    profiling.reset()


def spans(snap, name=None):
    return [s for s in snap["spans"] if name is None or s["name"] == name]


def children(snap, i, name=None):
    return [s for s in snap["spans"] if s["parent"] == i
            and (name is None or s["name"] == name)]


def _runner(epochs=4, num_cycles=1, hparams=HP, workdir=None,
            exploration=0.5, **kw):
    runner, loaders = build("csghmc", hparams, epochs=epochs,
                            num_cycles=num_cycles, workdir=workdir, **kw)
    runner.cfg.proportion_exploration = exploration
    runner._ensure_sched(len(loaders[0]))
    runner._train_loader = loaders[0]
    return runner, loaders


# ---- off ---------------------------------------------------------------------


def test_off_span_is_the_shared_noop_and_records_nothing():
    assert not profiling.recording()
    a, b = profiling.span("step", 3), profiling.span("forward")
    assert a is b is profiling._NO_SPAN
    with a:
        with b:
            profiling.count("to_device_bytes", 10, "batch")
            profiling.host_sync("epoch", 2)
    snap = profiling.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}


class _Forbidden:
    def __getattr__(self, name):
        raise AssertionError(f"the recorder touched {name} while off")


def test_off_span_and_count_make_no_torch_call_no_clock_read_and_no_allocation(
        monkeypatch):
    monkeypatch.setattr(profiling, "torch", _Forbidden())
    monkeypatch.setattr(profiling, "time", _Forbidden())
    for _ in range(10):  # warm every code path before measuring
        with profiling.span("step", 1):
            profiling.count("pinned_bytes", 8, "batch")
            profiling.host_sync("predict")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for i in range(1000):
            with profiling.span("step", i):
                profiling.count("pinned_bytes", 8, "batch")
                profiling.host_sync("predict")
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__
             and d.size_diff > 0]
    assert grown == []


# ---- the recorder on its own -------------------------------------------------


def test_spans_record_name_parent_id_and_host_times(recording):
    with profiling.span("epoch", 0):
        with profiling.span("step", 7):
            with profiling.span("update"):
                pass
        with profiling.span("step", 8):
            pass
        open_one = profiling.span("epoch.read")
        open_one.__enter__()
        snap = profiling.snapshot()
        open_one.__exit__(None, None, None)
    names = [(s["name"], s["parent"], s["id"]) for s in snap["spans"]]
    assert names == [("epoch", None, 0), ("step", 0, 7), ("update", 1, None),
                     ("step", 0, 8), ("epoch.read", 0, None)]
    assert snap["clock"] == "time_ns"
    for s in snap["spans"][1:4]:
        parent = snap["spans"][s["parent"]]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"]
    assert snap["spans"][0]["end_ns"] is None  # still open at the snapshot
    assert snap["spans"][4]["end_ns"] is None
    profiling.reset()
    assert profiling.snapshot()["spans"] == []


def test_counters_by_site_and_the_kernels_launch_counts(recording):
    profiling.count("to_device_bytes", 100, "batch")
    profiling.count("to_device_bytes", 20, "component")
    profiling.count("to_device_bytes", 1, "batch")
    profiling.host_sync("epoch", 2)
    profiling.host_sync("predict")
    snap = profiling.snapshot()
    assert snap["counters"] == {
        "to_device_bytes": {"batch": 101, "component": 20},
        "host_syncs": {"epoch": 2, "predict": 1}}
    assert snap["launches"] == kernels.launch_counts()
    assert json.loads(json.dumps(snap)) == snap


def test_chrome_events_are_on_the_profilers_timeline(recording):
    with profiling.span("step", 4):
        profiling.count("host_syncs", 2, "epoch")
    snap = profiling.snapshot()
    s = snap["spans"][0]
    base_ns = s["start_ns"] - 5_000_000
    events = profiling.chrome_events(snap, base_ns, pid=11)
    x, c = events
    assert x["ph"] == "X" and x["cat"] == c["cat"] == "program"
    assert x["ts"] == pytest.approx(5000.0)
    assert x["dur"] == pytest.approx((s["end_ns"] - s["start_ns"]) / 1e3)
    assert x["args"] == {"index": 0, "parent": None, "id": 4}
    assert (c["ph"], c["name"], c["args"]) == ("C", "host_syncs",
                                               {"epoch": 2})
    assert c["ts"] == pytest.approx(x["ts"] + x["dur"])


# ---- spans and counters where the work happens -------------------------------


def test_csghmc_epoch_span_tree_ids_and_host_syncs(recording):
    runner, (train, _, _) = _runner(exploration=0.0)
    steps = len(train)
    runner.train_one_epoch(0, train)  # no cycle ends in epoch 0
    snap = profiling.snapshot()
    (epoch,) = spans(snap, "epoch")
    assert epoch["id"] == 0 and epoch["parent"] is None
    e = snap["spans"].index(epoch)
    step_spans = children(snap, e, "step")
    assert [s["id"] for s in step_spans] == list(range(steps))
    assert len(children(snap, e, "loader.gather")) == steps
    assert len(children(snap, e, "after_batch")) == steps
    assert len(children(snap, e, "epoch.read")) == 1
    for bi, s in enumerate(step_spans):
        names = collections.Counter(c["name"] for c in children(
            snap, snap["spans"].index(s)))
        collect = runner._should_sample(bi)
        assert names == {"to_device": 2, "lr_vec": 1, "forward": 1,
                         "update": 1, **({"moments": 1} if collect else {})}
    assert any(runner._should_sample(bi) for bi in range(steps))
    assert snap["counters"]["host_syncs"] == {"epoch": 2}


def test_epoch_counts_the_batch_bytes_it_hands_over(recording):
    runner, (train, _, _) = _runner()
    runner.train_one_epoch(0, train)
    x, y, _ = next(iter(train))
    counters = profiling.snapshot()["counters"]
    assert counters["to_device_bytes"] == {
        "batch": len(train) * (x.nbytes + y.nbytes)}
    assert "pinned_bytes" not in counters  # nothing is pinned on the CPU


def test_cycle_end_spans_and_host_syncs(recording, tmp_path):
    runner, (train, _, _) = _runner(epochs=2, num_cycles=2,
                                    workdir=str(tmp_path))
    runner.train_one_epoch(0, train)  # cycle 1 ends at the epoch's last step
    snap = profiling.snapshot()
    (end,) = spans(snap, "cycle_end")
    assert end["id"] == 1
    assert snap["spans"][end["parent"]]["name"] == "after_batch"
    i = snap["spans"].index(end)
    assert [c["name"] for c in children(snap, i)] == [
        "cycle_end.snapshot", "cycle_end.likelihoods", "cycle_end.ckpt"]
    windows = sum(1 for _ in window_batches(train))
    syncs = snap["counters"]["host_syncs"]
    assert syncs["epoch"] == 2 and syncs["cycle_end"] == 3
    # one read per likelihood sample and window of stacked batches
    assert syncs["likelihoods"] == windows * runner.nst
    # the checkpoint reads the state's tensors: theta, v, the moments'
    assert syncs["ckpt"] >= 3


def test_fused_epoch_spans_its_segments(recording):
    runner, (train, _, _) = _runner()
    runner.cfg.fused_steps = True
    runner.train_one_epoch(0, train)
    snap = profiling.snapshot()
    (epoch,) = spans(snap, "epoch")
    e = snap["spans"].index(epoch)
    assert len(children(snap, e, "fused.segment")) >= 1
    assert len(children(snap, e, "epoch.read")) == 1
    assert snap["counters"]["host_syncs"] == {"epoch": 2}


def _with_components(runner, comps=3, seed=0):
    """The runner holding `comps` completed cycles as cycle ends leave
    them: host means, variances and likelihoods."""
    rs = np.random.RandomState(seed)
    theta = runner.state.theta.numpy()
    runner.cycle_stats = {
        c: {"mean": (theta + 0.01 * rs.randn(*theta.shape)).astype(
                np.float32),
            "var": (1e-4 * rs.uniform(0.5, 1.5, theta.shape)).astype(
                np.float32),
            "n": 2, "theta": None,
            "likelihoods": list(np.exp(-rs.uniform(2, 3, 2)))}
        for c in range(1, comps + 1)}
    runner.current_cycle = comps
    return runner


def test_mixture_predictive_counts_syncs_and_bytes(recording):
    runner, (_, _, test) = _runner()
    _with_components(runner, comps=3)
    runner.evaluate(test)
    counters = profiling.snapshot()["counters"]
    batches = len(test)
    assert counters["host_syncs"] == {"predict": batches * 3 * 2}
    x, _, _ = next(iter(test))
    assert counters["to_device_bytes"] == {
        "component": 3 * 2 * runner.target.dim * 4,
        "batch": batches * x.nbytes}


def test_mixture_predictive_span_tree(recording):
    runner, (_, _, test) = _runner()
    _with_components(runner, comps=2)
    runner.evaluate(test)
    runner.evaluate(test)
    snap = profiling.snapshot()
    passes = spans(snap, "predict.pass")
    assert len(passes) == 2 and passes[1]["id"] == passes[0]["id"] + 1
    for p in passes:
        i = snap["spans"].index(p)
        assert len(children(snap, i, "predict.upload")) == 1
        batch = children(snap, i, "predict.batch")
        assert [b["id"] for b in batch] == [(p["id"], k)
                                            for k in range(len(test))]
        for b in batch:
            names = collections.Counter(c["name"] for c in children(
                snap, snap["spans"].index(b)))
            # per component: the std, and each draw's normals and mean +
            # std * eps; its forwards; one read back; its share of the mix
            assert names == {"to_device": 1, "predict.draw": 2 * (1 + 2),
                             "forward": 2 * 2, "predict.readback": 2,
                             "predict.mix": 2 + 1}


def test_point_and_generic_predictive_passes(recording):
    runner, (_, _, test) = _runner()
    runner.evaluate(test)  # no completed cycle: the point estimate
    syncs = profiling.snapshot()["counters"]["host_syncs"]
    assert syncs == {"predict": len(test) + 2}
    profiling.reset()
    base.BaseRunner.evaluate(runner, test)
    snap = profiling.snapshot()
    assert snap["counters"]["host_syncs"] == {"predict": 2 * len(test) + 2}
    (p,) = spans(snap, "predict.pass")
    assert len(children(snap, snap["spans"].index(p), "predict.batch")) \
        == len(test)


@pytest.mark.parametrize("entry", ["csghmc_update_", "sgld_update_",
                                   "sghmc_update_", "draw_"])
def test_each_sampler_entry_is_an_update_span(entry, recording):
    """The recorded call gives the bits of the unrecorded one, inside one
    `update` span."""
    n = 4096
    gen = torch.Generator().manual_seed(1)
    g, theta, theta0, v = (torch.randn(n, generator=gen) for _ in range(4))
    mask, lr = torch.ones(n), torch.full((n,), 1e-3)
    calls = {
        "csghmc_update_": lambda a: fused.csghmc_update_(
            a[0], a[1], a[3], prior_sig=1.0, n_eff=100.0, nd=1.0, alpha=0.1,
            lr=lr, should_sample=True, seed=3, step=5),
        "sgld_update_": lambda a: fused.sgld_update_(
            a[0], a[1], a[2], mask, lr, prior_sig=1.0, n_eff=100.0, nd=1.0,
            seed=3, step=5),
        "sghmc_update_": lambda a: fused.sghmc_update_(
            a[0], a[1], a[2], a[3], mask, lr, prior_sig=1.0, n_eff=100.0,
            nd=1.0, alpha=0.1, seed=3, step=5),
        "draw_": lambda a: fused.draw_(a[1], kind="normal",
                                       stream=kernels.STREAM_VI, seed=3,
                                       step=5),
    }
    out = []
    for on in (True, False):
        profiling.enable(on)
        args = [t.clone() for t in (g, theta, theta0, v)]
        got = calls[entry](args)
        out.append(torch.cat([t.flatten() for t in
                              (got if isinstance(got, tuple) else (got,))]))
    profiling.enable(True)
    assert torch.equal(out[0], out[1])
    assert [s["name"] for s in profiling.snapshot()["spans"]] == ["update"]


def test_forward_span_holds_the_per_leaf_cast(recording):
    model, _, _ = create_backbone("mlp_mnist", width=16, depth=2,
                                  dtype="bfloat16")
    target, theta, ns = make_flat_target(
        model, nd_size=64, num_classes=10,
        rng=torch.Generator().manual_seed(0), device="cpu")
    assert target.fwd_cast == "bfloat16"
    target.forward(theta, ns, torch.zeros(2, 784))
    snap = profiling.snapshot()
    assert [(s["name"], s["parent"]) for s in snap["spans"]] == [
        ("forward", None), ("forward.cast", 0)]


def test_loader_gather_span_closes_before_each_batch_is_handed_out(
        recording):
    loader = ArrayLoader(np.zeros((10, 3), np.float32), np.arange(10), 4)
    with profiling.span("consumer"):
        for _ in loader:
            with profiling.span("use"):
                pass
    snap = profiling.snapshot()
    gathers = spans(snap, "loader.gather")
    assert len(gathers) == 3  # the last batch padded
    assert all(s["parent"] == 0 for s in spans(snap, "use"))
    assert all(s["parent"] == 0 for s in gathers)


# ---- one clock with the profiler ---------------------------------------------


def test_span_clock_places_profiled_ops_inside_their_forward_spans():
    """Under a CPU torch.profiler profile, each aten::addmm and aten::mm of
    the profiled block lies inside the `forward` span that ran it once the
    span is converted onto the Chrome trace's timeline; a product run
    between the forwards lies inside none."""
    model, _, _ = create_backbone("mlp_mnist", width=64, depth=2)
    target, theta, ns = make_flat_target(
        model, nd_size=64, num_classes=10,
        rng=torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(32, 784)
    a = torch.randn(64, 64)
    was = profiling.enable(True)
    profiling.reset()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with torch.no_grad():
                for _ in range(5):
                    target.forward(theta, ns, x)
                    torch.mm(a, a)  # outside every span
        snap = profiling.snapshot()
    finally:
        profiling.enable(was)
        profiling.reset()
    doc = _chrome(prof)
    base_ns = int(doc.get("baseTimeNanoseconds", 0))
    fwd = [(profiling.to_trace_us(s["start_ns"], base_ns),
            profiling.to_trace_us(s["end_ns"], base_ns))
           for s in spans(snap, "forward")]
    assert len(fwd) == 5
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in doc["traceEvents"] if e.get("cat") == "cpu_op"
           and e.get("name") in ("aten::addmm", "aten::mm")]
    inside = collections.Counter()
    outside = 0
    for t0, t1, name in ops:
        hits = [k for k, (a0, a1) in enumerate(fwd) if a0 <= t0 and t1 <= a1]
        if hits:
            inside[hits[0]] += 1
        else:
            assert name == "aten::mm", (name, t0, t1, fwd)
            outside += 1
    # 3 layers a forward, each one product; 5 products outside
    assert sorted(inside.values()) == [3] * 5
    assert outside == 5


def _chrome(prof) -> dict:
    import os
    import tempfile
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


@pytest.mark.parametrize("where", ["head", "tail", "none"])
def test_export_reads_the_trace_base_from_its_head_or_tail(where, tmp_path):
    """The base of the sidecar file is read without parsing the events,
    wherever the profiler wrote it; 0 where the trace has none."""
    filler = [{"ph": "X", "name": f"op{i}", "ts": i, "dur": 1}
              for i in range(40_000)]  # well over the 64 KiB tail read
    body = json.dumps(filler)
    base = '"baseTimeNanoseconds": 1790857026000000000'
    text = {"head": '{"schemaVersion": 1, %s, "traceEvents": %s}',
            "tail": '{"traceEvents": %s, "traceName": "t", %s}',
            "none": '{"traceEvents": %s}'}[where]
    text = (text % (base, body) if where == "head"
            else text % (body, base) if where == "tail" else text % body)
    path = tmp_path / "t.pt.trace.json"
    path.write_text(text)
    assert len(text) > (1 << 20)
    assert profiling._base_ns(str(path)) == (
        0 if where == "none" else 1790857026000000000)
