"""Inference methods (counterpart of bayesdll_tpu.methods).

Each method module exposes a `Runner(target, theta_init, net_state, cfg)`
with `runner.train(train_loader, val_loader, test_loader) -> results`.
"""

from __future__ import annotations

import importlib

_METHODS = {name: f"bayesdll_tpu_torch.methods.{name}" for name in (
    "vanilla", "vi", "mc_dropout", "sgld", "sghmc", "adam_sghmc", "csgld",
    "csghmc", "adam_csghmc", "csghmc_fs", "la")}


def get_runner_cls(method: str):
    if method not in _METHODS:
        raise NotImplementedError(
            f"method '{method}' is not ported (not a method of "
            f"bayesdll_tpu); ported: {sorted(_METHODS)}")
    return importlib.import_module(_METHODS[method]).Runner
