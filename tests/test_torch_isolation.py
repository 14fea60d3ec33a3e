"""The PyTorch port, chip_smoke.py, resnet_sweep.py and vit_cast_forms.py
stand alone: they
import nothing of JAX, flax or the JAX package (the machine with
the card has none of them)."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "bayesdll_tpu")
SOURCES = sorted((ROOT / "bayesdll_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "resnet_sweep.py", ROOT / "vit_cast_forms.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_in_source(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import json, sys\n"
        "import bayesdll_tpu_torch.methods.csghmc, bayesdll_tpu_torch.cli.demo\n"
        "import bayesdll_tpu_torch.methods.sgld, bayesdll_tpu_torch.methods.sghmc\n"
        "import bayesdll_tpu_torch.methods.csgld\n"
        "import bayesdll_tpu_torch.models.resnet, bayesdll_tpu_torch.models.cnn\n"
        "import bayesdll_tpu_torch.models.vit\n"
        "import bayesdll_tpu_torch.models.convert, bayesdll_tpu_torch.models.layers\n"
        "import bayesdll_tpu_torch.interop, chip_smoke, resnet_sweep\n"
        "import vit_cast_forms\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"    if m.split('.')[0] in {FORBIDDEN!r})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_refuses_to_run_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_resnet_sweep_refuses_to_run_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "resnet_sweep.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "resnet101 csghmc" not in out.stdout


def test_vit_cast_forms_refuses_to_run_without_a_card():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, "vit_cast_forms.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "ms/step" not in out.stdout
