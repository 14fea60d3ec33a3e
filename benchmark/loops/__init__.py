"""The generators of traffic, one module per loop kind, found by the name
that a traffic mix's `loop` gives: `benchmark/loops/<loop>.py`, whose
`Loop(cell, seed, device)` reads the mix's parameters and gives
  * `metric`: the end-to-end rate that its window measures;
  * `training`: whether its cells are training cells (their planted
    faults set upper readings of the correctness limits);
  * `setup(warm=True)`, `window(seconds)`, `traced()`, `free()` and
    `check()`, which run.py calls in that order;
  * `calibration_outputs()` and `stand_ins()`: what calibrate.py reads
    after `setup(warm=False)`: the program's outputs that `check()`
    compares, and the control's and the planted faults' numbers.
"""

from __future__ import annotations

import importlib


def load(kind: str):
    """The `Loop` class of a loop kind."""
    return importlib.import_module(f"{__name__}.{kind}").Loop
