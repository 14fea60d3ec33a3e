"""Inference methods (counterpart of bayesdll_tpu.methods).

Each method module exposes a `Runner(target, theta_init, net_state, cfg)`
with `runner.train(train_loader, val_loader, test_loader) -> results`.
"""

from __future__ import annotations

import importlib

_METHODS = {
    "csghmc": "bayesdll_tpu_torch.methods.csghmc",
    "csgld": "bayesdll_tpu_torch.methods.csgld",
    "sghmc": "bayesdll_tpu_torch.methods.sghmc",
    "sgld": "bayesdll_tpu_torch.methods.sgld",
}

# where each method of the JAX package stands in ROADMAP.md queue 1
_PENDING = {
    "adam_sghmc": 9, "adam_csghmc": 9, "csghmc_fs": 9,
    "vanilla": 10, "vi": 10, "mc_dropout": 10, "la": 10,
}


def get_runner_cls(method: str):
    if method not in _METHODS:
        where = (f"ROADMAP.md queue 1 item {_PENDING[method]}"
                 if method in _PENDING else "not a method of bayesdll_tpu")
        raise NotImplementedError(
            f"method '{method}' is not ported yet ({where}); "
            f"ported: {sorted(_METHODS)}")
    return importlib.import_module(_METHODS[method]).Runner
