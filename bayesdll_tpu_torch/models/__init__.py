"""Backbone registry (counterpart of bayesdll_tpu.models).

`create_backbone(name, num_classes)` returns `(module, input_shape, meta)`.
Every backbone names its readout submodule ``head`` so that
`core/flat.path_masks` finds the head parameters.
"""

from __future__ import annotations

from typing import Tuple

from bayesdll_tpu_torch.models.mlp import MLP

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


@register("mlp_mnist")
def _mlp_mnist(num_classes: int = 10, **kw):
    model = MLP(num_classes=num_classes, width=kw.get("width", 1000),
                depth=kw.get("depth", 3),
                activation=kw.get("activation", "relu"), input_dim=784)
    return model, (784,), {"has_batch_stats": False, "has_dropout": False}


def create_backbone(name: str, num_classes: int = 10, **kw) -> Tuple:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone '{name}' is not ported yet (ROADMAP.md queue 1 item "
            f"11, backbones); ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name](num_classes=num_classes, **kw)
