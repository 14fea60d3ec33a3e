"""The port's profiling, wandb and terminal utilities against the JAX
package's on the CPU: the forward-FLOP table, cprint's bytes, the wandb
shim's calls with a stub `wandb` module, the CLI's wandb calls when
training raises, and the CLI's --profile_dir trace with the program's
spans and counters in it."""

import importlib
import json
import sys
import types

import numpy as np
import pytest

from bayesdll_tpu.utils import profiling as jprofiling
from bayesdll_tpu.utils import term as jterm
from bayesdll_tpu.utils import wandb_compat as jwandb
from bayesdll_tpu_torch.utils import profiling, term, wandb_compat
from tests.test_torch_multichain_runner import one_thread  # noqa: F401


def test_constants_match_jax():
    # every backbone of the JAX package at its value; beside them only
    # SwinV2-L, which the JAX package does not have (2 x 115.38 GMACs)
    ours = dict(profiling.FWD_FLOPS_PER_EXAMPLE)
    assert ours.pop("swinv2_l_w24_384") == 230.8e9
    assert ours == jprofiling.FWD_FLOPS_PER_EXAMPLE
    assert profiling.BF16_PEAK == 989e12 and profiling.FP32_PEAK == 67e12


@pytest.mark.parametrize("color", ["red", "green", "cyan", "no-such-color"])
def test_cprint_matches_jax(color, capsys):
    term.cprint(color, "chain 0: θ saved")
    ours = capsys.readouterr()
    jterm.cprint(color, "chain 0: θ saved")
    assert ours == capsys.readouterr()


def test_mkdir(tmp_path):
    term.mkdir(str(tmp_path / "a" / "b"), str(tmp_path / "c"))
    term.mkdir(str(tmp_path / "c"))
    assert (tmp_path / "a" / "b").is_dir() and (tmp_path / "c").is_dir()


def _stub_wandb(calls):
    """A `wandb` module that records the shim's calls."""
    mod = types.ModuleType("wandb")
    mod.run = None

    def init(**kw):
        calls.append(("init", kw))
        mod.run = types.SimpleNamespace(summary={})
        return mod.run

    def log(metrics, step=None):
        calls.append(("log", metrics, step))

    def finish():
        calls.append(("finish", dict(mod.run.summary)))
        mod.run = None

    mod.init, mod.log, mod.finish = init, log, finish
    return mod


@pytest.fixture
def stub_wandb():
    """Both shims reloaded over a stub `wandb`, and reloaded without it
    after the test."""
    calls = []
    saved = sys.modules.get("wandb")
    sys.modules["wandb"] = _stub_wandb(calls)
    for shim in (wandb_compat, jwandb):
        importlib.reload(shim)
    try:
        yield calls
    finally:
        if saved is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved
        for shim in (wandb_compat, jwandb):
            importlib.reload(shim)


def test_wandb_shim_matches_jax(stub_wandb):
    def use(shim):
        shim.log({"loss": 1.0})  # no run yet: nothing
        shim.init(project="bayesdll-tpu", name="run", config={"lr": 0.1})
        shim.log({"loss": 0.5}, step=3)
        shim.summary({"nll": 0.25, "test_err": 0.1, "curve": [1, 2],
                      "best_epoch": 4})
        shim.finish()
        shim.finish()  # no run left: nothing

    assert wandb_compat.HAS_WANDB and jwandb.HAS_WANDB
    use(wandb_compat)
    ours = list(stub_wandb)
    stub_wandb.clear()
    use(jwandb)
    assert ours == stub_wandb
    assert [c[0] for c in ours] == ["init", "log", "finish"]
    assert ours[-1][1] == {"nll": 0.25, "test_err": 0.1, "best_epoch": 4}


def test_wandb_shim_without_wandb():
    """Where wandb does not import, as here, every call is a no-op."""
    saved = sys.modules.get("wandb")
    sys.modules["wandb"] = None  # its import raises ImportError
    try:
        importlib.reload(wandb_compat)
        assert not wandb_compat.HAS_WANDB
        assert wandb_compat.init(project="p") is None
        wandb_compat.log({"loss": 1.0})
        wandb_compat.summary({"nll": 1.0})
        wandb_compat.finish()
    finally:
        if saved is None:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = saved
        importlib.reload(wandb_compat)


def _small_prepare(monkeypatch):
    """The CLI's synthetic set cut to 128 training and 64 test examples."""
    import bayesdll_tpu_torch.data as data
    prepare_full = data.prepare

    def small(cfg):
        cfg.synthetic_n_train, cfg.synthetic_n_test = 128, 64
        return prepare_full(cfg)
    monkeypatch.setattr(data, "prepare", small)


CLI = ["--method", "csghmc", "--dataset", "synthetic", "--epochs", "1",
       "--num_cycles", "1", "--batch_size", "64", "--lr", "1e-3",
       "--device", "cpu",
       "--hparams", "prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,nst=2"]


def test_cli_wandb_finishes_when_train_raises(stub_wandb, monkeypatch,
                                              tmp_path):
    from bayesdll_tpu_torch.cli import demo
    from bayesdll_tpu_torch.methods.base import BaseRunner
    _small_prepare(monkeypatch)

    def broken(*a, **kw):
        raise RuntimeError("train failed")
    monkeypatch.setattr(BaseRunner, "train", broken)
    with pytest.raises(RuntimeError, match="train failed"):
        demo.main(CLI + ["--log_dir", str(tmp_path), "--use_wandb",
                         "--wandb_name", "wb"])
    assert [c[0] for c in stub_wandb] == ["init", "finish"]
    init = stub_wandb[0][1]
    assert init["project"] == "bayesdll-tpu" and init["name"] == "wb"
    assert init["config"]["use_wandb"] is True


def test_cli_profile_dir_writes_a_trace(monkeypatch, tmp_path):
    """`--profile_dir` traces `train`: a TensorBoard trace file whose JSON
    holds the run's events."""
    from bayesdll_tpu_torch.cli import demo
    _small_prepare(monkeypatch)
    res = demo.main(CLI + ["--log_dir", str(tmp_path / "logs"),
                           "--profile_dir", str(tmp_path / "trace")])
    assert np.isfinite(res["nll"])
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_cli_profile_dir_trace_holds_the_program_spans(monkeypatch, tmp_path):
    """Beside the trace file, `<same stem>.program.json` holds the
    recorder's spans and counters, as events of category "program" on the
    trace's timeline (its `baseTimeNanoseconds`): an epoch span over its
    steps, each step's id its global step, every forward's aten::matmul
    inside a `forward` span, and the counters; the trace file itself is
    the profiler's as written, and the recorder is off and empty after."""
    from bayesdll_tpu_torch.cli import demo
    _small_prepare(monkeypatch)
    demo.main(CLI + ["--log_dir", str(tmp_path / "logs"),
                     "--profile_dir", str(tmp_path / "trace")])
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    side = path.with_name(path.name[:-len(".pt.trace.json")]
                          + ".program.json")
    assert sorted(p.name for p in (tmp_path / "trace").iterdir()) == sorted(
        [path.name, side.name])
    with open(path) as f:
        doc = json.load(f)
    with open(side) as f:
        program = json.load(f)
    assert program["baseTimeNanoseconds"] == doc["baseTimeNanoseconds"] > 0
    events = doc["traceEvents"]
    assert not any(e.get("cat") == "program" for e in events)
    prog = program["traceEvents"]
    assert all(e.get("cat") == "program" for e in prog)
    spans = [e for e in prog if e["ph"] == "X"]
    epochs = [e for e in spans if e["name"] == "epoch"]
    steps = [e for e in spans if e["name"] == "step"]
    assert [e["args"]["id"] for e in epochs] == [0]
    assert steps and [e["args"]["id"] for e in steps] == list(
        range(len(steps)))
    ep = epochs[0]
    for s in steps:
        assert ep["ts"] <= s["ts"] and s["ts"] + s["dur"] <= ep["ts"] + ep["dur"]
    forwards = [(e["ts"], e["ts"] + e["dur"]) for e in spans
                if e["name"] == "forward"]
    matmul = [e for e in events if e.get("cat") == "cpu_op"
              and e.get("name") == "aten::matmul"]
    assert matmul and all(any(a <= e["ts"] and e["ts"] + e["dur"] <= b
                              for a, b in forwards) for e in matmul)
    counters = {e["name"]: e["args"] for e in prog if e["ph"] == "C"}
    assert counters["host_syncs"]["epoch"] == 2
    assert counters["to_device_bytes"]["batch"] > 0
    assert not profiling.recording() and profiling.snapshot()["spans"] == []


def test_cli_flags_defaults_match_jax():
    """The new flags parse as in the JAX package, with its defaults."""
    from bayesdll_tpu.cli import demo as jdemo
    from bayesdll_tpu_torch.cli import demo
    keys = ("ckpt_backend", "profile_dir", "use_wandb", "wandb_project",
            "wandb_name")
    ours, theirs = demo.parse_args([]), jdemo.parse_args([])
    assert {k: getattr(ours, k) for k in keys} == \
        {k: getattr(theirs, k) for k in keys}
    argv = ["--ckpt_backend", "orbax", "--profile_dir", "p", "--use_wandb",
            "--wandb_project", "proj", "--wandb_name", "n"]
    ours, theirs = demo.parse_args(argv), jdemo.parse_args(argv)
    assert {k: getattr(ours, k) for k in keys} == \
        {k: getattr(theirs, k) for k in keys}
    with pytest.raises(SystemExit):
        demo.parse_args(["--ckpt_backend", "tensorstore"])


def test_alias_entry_points_pass_the_new_flags(monkeypatch):
    """demo_vision and demo_mnist hand every flag to demo.main, the new ones
    included."""
    from bayesdll_tpu_torch.cli import demo, demo_mnist, demo_vision
    seen = []
    monkeypatch.setattr(demo, "main", lambda argv: seen.append(
        demo.parse_args(argv)))
    argv = ["--ckpt_backend", "orbax", "--profile_dir", "t", "--use_wandb",
            "--wandb_name", "n"]
    demo_vision.main(list(argv))
    demo_mnist.main(list(argv))
    for args in seen:
        assert (args.ckpt_backend, args.profile_dir, args.use_wandb,
                args.wandb_name) == ("orbax", "t", True, "n")
