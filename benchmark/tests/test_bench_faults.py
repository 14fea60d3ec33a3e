"""Whole runs of the harness at tiny widths on the CPU (the look for a card
skipped): sound runs come out correct, and a run whose timed path is
broken underneath, or whose program is the control, comes out not
correct.  Also: nothing of JAX is loaded by a run."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import compare, loops, run, spec

from conftest import ROOT

SEED = 2 ** 31 + 77


def cpu_run(root, cell, seed=SEED, seconds=0.3):
    torch.manual_seed(0)
    return run.run(cell, seed, seconds, False, root=root, dev="cpu",
                   t0=time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny_vit.sample", "tiny_vit.predict",
                                  "tiny_resnet.predict"])
def test_a_sound_run_is_correct(tiny_root, cell):
    res = cpu_run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    names = {m["name"] for m in spec.load_cell(cell, tiny_root).end_to_end}
    assert set(res["metrics"]) == names


def _unchanged(monkeypatch):
    from bayesdll_tpu_torch.ops import fused
    monkeypatch.setattr(fused, "csghmc_update_",
                        lambda g, theta, v, **kw: (theta, v))


def _half_batch(monkeypatch):
    from bayesdll_tpu_torch.methods import base
    real = base.ce_loss
    monkeypatch.setattr(base, "ce_loss",
                        lambda logits, y: real(logits[:len(y) // 2],
                                               y[:len(y) // 2]))


def _answer_altered(monkeypatch):
    from bayesdll_tpu_torch.methods import base
    real = base.combine_mc_logits

    def altered(la):
        out = real(la).clone()
        out[0, 0] += 2.0
        return out
    monkeypatch.setattr(base, "combine_mc_logits", altered)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_vit.sample", _unchanged),
    ("tiny_vit.sample", _half_batch),
    ("tiny_vit.predict", _answer_altered),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    fault(monkeypatch)
    res = cpu_run(tiny_root, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_the_control_is_not_correct(tiny_root, seed):
    """The reference with fp8 products in the program's place fails the
    tiny cells' limits, in the sampling and the predictive cell."""
    for cell_name in ("tiny_vit.sample", "tiny_vit.predict"):
        cell = spec.load_cell(cell_name, tiny_root)
        loop = loops.load(cell.traffic["loop"])(cell, seed, "cpu")
        loop.setup(warm=False)
        loop.calibration_outputs()
        got = loop.stand_ins()
        ok, _ = compare.judge(got["control_fp8"], cell.limits)
        assert not ok, (cell_name, got["control_fp8"])


def test_a_run_loads_nothing_of_jax(tiny_root):
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from benchmark import run, device\n"
        "run.run('tiny_vit.sample', 5, 0.1, False, root=%r, dev='cpu',"
        " t0=time.perf_counter())\n"
        "run.run('tiny_vit.predict', 5, 0.1, False, root=%r, dev='cpu',"
        " t0=time.perf_counter())\n"
        "print(device.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    ) % (str(ROOT), str(tiny_root), str(tiny_root))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout.splitlines()
    assert out[-2] == "[]"
    top = set(eval(out[-1]))
    assert "bayesdll_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "bayesdll_tpu"}


def test_without_a_card_the_run_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "vit_l_32.sample",
         "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    import shutil
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "vit_l_32.sample",
         "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_each_cell_runs_correct_on_the_card(card, cell):
    res = run.run(cell, SEED, 3.0, False, t0=time.perf_counter())
    assert res["correct"], res["checks"]
