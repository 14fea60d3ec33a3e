"""What `BENCHMARK.json` and the files beside it say about a cell.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
`BENCHMARK.json` gives it:

  * a configuration: the file its entry names (`benchmark/configs/`);
  * a traffic mix: `benchmark/traffic/<traffic>.json`, parameters read by
    the generator that its `loop` names, `benchmark/loops/<loop>.py`;
  * the reference's architecture of a configuration:
    `benchmark/reference/arch/<architecture>.py`;
  * a cell's correctness limits: `benchmark/limits/<cell>.json`;
  * a per-layer metric: `benchmark/metrics/<metric>.py`, whose
    `read(ctx)` returns the number or None.

So a later change adds a cell, a configuration, a mix, a loop kind, an
architecture or a metric by adding files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parent.parent
HERE = "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic mix's parameters
    limits: dict          # {number: {"limit": x, ...}}
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, Callable]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_reader(path: Path) -> Callable:
    """The `read` function of a metric's reader file."""
    mod_name = "benchmark_metric_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, workload: str):
    """(end-to-end, per-layer) metric entries that the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e, layer = metrics_of(bench, workload)
    return Cell(
        name=workload, chips=int(entry["chips"]),
        config=_json(root / conf["file"]),
        traffic=_json(root / HERE / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(root / HERE / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=layer,
        readers={m["name"]: load_reader(root / HERE / "metrics"
                                        / f"{m['name']}.py")
                 for m in layer})
