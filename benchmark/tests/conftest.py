"""Fixtures of the benchmark's tests: the repository on sys.path, the
`card` marker for tests that need a CUDA card (skipped inside the `card`
fixture where there is none), and `tiny_root`, a benchmark root whose
cells run the harness at tiny widths on the CPU."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the tiny ResNet's training step is left out: at 32x32 and batch 8 its
# bf16 gradient is as far from the fp32 reference's as the fp8 control's
TINY_CELLS = ["tiny_vit.sample", "tiny_vit.predict", "tiny_resnet.predict"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped where there is none)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")


def make_tiny_root(dest: Path) -> Path:
    """A copy of the benchmark's metric readers with the tiny configs,
    mixes and limits of tests/data, and a BENCHMARK.json whose cells are
    the tiny ones under the real metrics."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = dest / "benchmark"
    b.mkdir(parents=True)
    for sub in ("configs", "traffic", "limits"):
        shutil.copytree(DATA / sub, b / sub)
    shutil.copytree(ROOT / "benchmark" / "metrics", b / "metrics")
    bench["configs"] = [{"name": c, "source": "https://arxiv.org/abs/0000",
                         "file": f"benchmark/configs/{c}.json",
                         "reduced": [], "why": "tiny"}
                        for c in ("tiny_vit", "tiny_resnet")]
    bench["workloads"] = [{"name": w, "config": w.split(".")[0],
                           "traffic": w.split(".")[1], "chips": 1,
                           "why": "tiny"} for w in TINY_CELLS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "sample" if "sample" in m["workloads"][0] else "predict"
            m["workloads"] = [w for w in TINY_CELLS if w.endswith(kind)]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
