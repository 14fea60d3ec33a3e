"""Optional wandb integration (counterpart of bayesdll_tpu.utils.wandb_compat;
reference `demo_mnist.py:100-146,232-252`).

wandb is not installed in every environment; this shim exposes the handful
of calls the entry points use and silently no-ops when the package is
missing.
"""

from __future__ import annotations

try:
    import wandb as _wandb
    HAS_WANDB = True
except ImportError:  # pragma: no cover - depends on environment
    _wandb = None
    HAS_WANDB = False


def init(project=None, name=None, config=None, mode=None):
    if not HAS_WANDB:
        return None
    return _wandb.init(project=project, name=name, config=config, mode=mode)


def log(metrics: dict, step=None):
    if HAS_WANDB and _wandb.run is not None:
        _wandb.log(metrics, step=step)


def summary(results: dict):
    """Final/best summary metrics (reference `demo_mnist.py:232-252`)."""
    if HAS_WANDB and _wandb.run is not None:
        for k, v in results.items():
            if isinstance(v, (int, float)):
                _wandb.run.summary[k] = v


def finish():
    if HAS_WANDB and _wandb.run is not None:
        _wandb.finish()
