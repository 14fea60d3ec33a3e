"""BENCHMARK.json against the benchmark's contract, and the files it names
found by name alone."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import spec

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def _line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit \
        and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for section, keys in KEYS.items():
        for entry in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end",
                                                 "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, entry
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert spec.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert spec.UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
    if section == "workloads":
        for e in BENCH[section]:
            assert spec.NAME.match(e["config"]) and spec.NAME.match(
                e["traffic"])
    if section == "configs":
        for e in BENCH[section]:
            assert len(e["reduced"]) <= 16
            assert all(spec.NAME.match(k) for k in e["reduced"])


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    files = [w for w in cmd if "/" in w]
    assert files and all(any(f.startswith(p + "/") for p in paths)
                         for f in files)


def test_every_file_under_paths_is_named_from_name_characters():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts or f.is_dir():
                continue
            rel = str(f.relative_to(ROOT))
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_metrics_cells_and_readers():
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and m["bound"] >= 0.01
        assert set(m.get("workloads", [])) <= set(cells)
    layers = set()
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m.get("workloads", cells):
            reported, _ = spec.metrics_of(BENCH, w)
            assert m["moves"] in {r["name"] for r in reported}, (m, w)
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        layers.add(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported, layer = spec.metrics_of(BENCH, w)
        names = {r["name"] for r in reported}
        assert "setup_s" in names and len(names) >= 2 and layer, w
    assert layers


def test_configs_cells_and_chips():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        loop = ROOT / "benchmark" / "loops" / f"{cell.traffic['loop']}.py"
        assert cell.limits and loop.exists()
        arch = cell.config["architecture"]
        assert (ROOT / "benchmark" / "reference" / "arch"
                / f"{arch}.py").exists()


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_config_mix_and_metric_are_found_from_new_files(tmp_path):
    """A later change adds a configuration of a new architecture, a traffic
    mix of a new loop kind, a cell and a per-layer metric by adding files
    and entries: the harness finds each by name, and a tiny run of the new
    cell from a copy of the benchmark comes out correct, with no file that
    was there edited."""
    root = tmp_path / "repo"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digest(root / "benchmark")
    b, data = root / "benchmark", ROOT / "benchmark" / "tests" / "data"
    shutil.copy(b / "reference" / "arch" / "vit.py",
                b / "reference" / "arch" / "vit_copy.py")
    shutil.copy(b / "loops" / "sample.py", b / "loops" / "sample_copy.py")
    conf = json.loads((data / "configs" / "tiny_vit.json").read_text())
    conf.update(name="tiny_vit_copy", architecture="vit_copy")
    (b / "configs" / "tiny_vit_copy.json").write_text(json.dumps(conf))
    mix = json.loads((data / "traffic" / "sample.json").read_text())
    mix["loop"] = "sample_copy"
    (b / "traffic" / "sample_copy.json").write_text(json.dumps(mix))
    cell_name = "tiny_vit_copy.sample_copy"
    shutil.copy(data / "limits" / "tiny_vit.sample.json",
                b / "limits" / f"{cell_name}.json")
    (b / "metrics" / "steps_traced.sample_copy.py").write_text(
        "def read(ctx):\n    return float(ctx['traced']['steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_vit_copy", "source": "x",
                             "file": "benchmark/configs/tiny_vit_copy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell_name, "config": "tiny_vit_copy",
                               "traffic": "sample_copy", "chips": 1,
                               "why": "x"})
    bench["end_to_end"][0]["workloads"].append(cell_name)
    bench["per_layer"].append({"name": "steps_traced.sample_copy",
                               "unit": "1", "better": "higher",
                               "source": "device_trace",
                               "layer": "sampling step",
                               "moves": "train_img_per_s",
                               "workloads": [cell_name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(cell_name, root)
    assert cell.config["architecture"] == "vit_copy"
    assert cell.traffic["loop"] == "sample_copy"
    assert cell.readers["steps_traced.sample_copy"](
        {"traced": {"steps": 7}}) == 7
    assert [m["name"] for m in cell.end_to_end] == ["train_img_per_s",
                                                    "setup_s"]
    code = (
        "import sys, json, time\n"
        "sys.path[:0] = [%r, %r]\n"
        "from benchmark import run\n"
        "res = run.run(%r, 2 ** 31 + 5, 0.2, False, root=%r, dev='cpu',"
        " t0=time.perf_counter())\n"
        "import benchmark\n"
        "print(json.dumps([res['correct'], benchmark.__file__, sorted("
        "m for m in sys.modules if m.endswith('_copy'))]))\n"
    ) % (str(root), str(ROOT), cell_name, str(root))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                         capture_output=True, text=True)
    correct, where, copies = json.loads(out.stdout.splitlines()[-1])
    assert correct, out.stderr[-2000:]
    assert where.startswith(str(root))
    assert copies == ["benchmark.loops.sample_copy",
                      "benchmark.reference.arch.vit_copy"]
    after = _digest(b)
    assert all(after[k] == v for k, v in before.items())
