"""Plain float32 forward passes from the flat vector's views (layout.py),
by the configuration's architecture (arch/<architecture>.py)."""

from __future__ import annotations

from benchmark.reference import arch


def forward(p, x, config, ops, stats=None, train=True):
    """Logits; `stats` the running statistics an evaluation normalises
    by, where the architecture keeps them."""
    return arch.module(config).forward(p, x, config, ops, stats=stats,
                                       train=train)


def batch_stats(p, x, config):
    """The running statistics of a training-mode forward of `x`, or None
    for an architecture that keeps none."""
    fn = getattr(arch.module(config), "batch_stats", None)
    return None if fn is None else fn(p, x, config)
