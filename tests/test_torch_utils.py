"""The port's profiling, wandb and terminal utilities against the JAX
package's on the CPU: StepTimer's stats on the same clock readings, the
forward-FLOP table, cprint's bytes, the wandb shim's calls with a stub
`wandb` module, the CLI's wandb calls when training raises, and the CLI's
--profile_dir trace."""

import importlib
import json
import sys
import time
import types

import numpy as np
import pytest
import torch

from bayesdll_tpu.utils import profiling as jprofiling
from bayesdll_tpu.utils import term as jterm
from bayesdll_tpu.utils import wandb_compat as jwandb
from bayesdll_tpu_torch.utils import profiling, term, wandb_compat
from tests.test_torch_multichain_runner import one_thread  # noqa: F401


def test_step_timer_stats_match_jax(monkeypatch):
    """Both timers on the same perf_counter readings: the same stats."""
    starts = np.cumsum(np.random.RandomState(0).uniform(0.5, 2.0, 7))
    lengths = np.random.RandomState(1).uniform(1e-3, 5e-2, 7)
    readings = [float(x) for s, d in zip(starts, lengths) for x in (s, s + d)]
    out = []
    # the port's fence is a tensor (a CPU one: no synchronize), JAX's none
    for timer, fence in ((profiling.StepTimer(), torch.zeros(2)),
                         (jprofiling.StepTimer(), None)):
        assert timer.stats() == {}
        clock = iter(readings)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        for _ in range(len(starts)):
            with timer.measure(fence):
                pass
        out.append(timer.stats())
    assert out[0] == out[1]
    assert out[0]["steps"] == 7
    assert out[0]["mean_s"] == pytest.approx(float(lengths.mean()))


def test_constants_match_jax():
    assert profiling.FWD_FLOPS_PER_EXAMPLE == jprofiling.FWD_FLOPS_PER_EXAMPLE
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
