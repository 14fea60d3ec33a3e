"""Backbone registry (counterpart of bayesdll_tpu.models).

`create_backbone(name, num_classes, dtype=...)` returns `(module,
input_shape, meta)` with meta's `has_batch_stats` and `has_dropout` flags.
Every backbone names its readout submodule ``head`` so that
`core/flat.path_masks` finds the head parameters.
"""

from __future__ import annotations

from typing import Tuple

from bayesdll_tpu_torch.models.cnn import SmallCNN
from bayesdll_tpu_torch.models.mlp import MLP
from bayesdll_tpu_torch.models.resnet import STAGE_SIZES, ResNet

_REGISTRY = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


@register("mlp_mnist")
def _mlp_mnist(num_classes: int = 10, **kw):
    if kw.get("dtype", "float32") != "float32":
        raise NotImplementedError(
            "mlp_mnist runs in float32 in the port; its half-precision "
            "forward is not ported yet (ROADMAP.md queue 1 item 11)")
    model = MLP(num_classes=num_classes, width=kw.get("width", 1000),
                depth=kw.get("depth", 3),
                activation=kw.get("activation", "relu"), input_dim=784)
    return model, (784,), {"has_batch_stats": False, "has_dropout": False}


@register("cnn_mnist")
def _cnn_mnist(num_classes: int = 10, **kw):
    model = SmallCNN(num_classes=num_classes, dtype=kw.get("dtype", "float32"))
    return model, (28, 28, 1), {"has_batch_stats": False, "has_dropout": False}


def _resnet(name, num_classes, kw):
    model = ResNet(stage_sizes=STAGE_SIZES[name], num_classes=num_classes,
                   dtype=kw.get("dtype", "float32"))
    return model, (224, 224, 3), {"has_batch_stats": True,
                                  "has_dropout": False}


@register("resnet101")
def _resnet101(num_classes: int = 1000, **kw):
    return _resnet("resnet101", num_classes, kw)


@register("resnet50")
def _resnet50(num_classes: int = 1000, **kw):
    return _resnet("resnet50", num_classes, kw)


def create_backbone(name: str, num_classes: int = 10, **kw) -> Tuple:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone '{name}' is not ported yet (ROADMAP.md queue 1 item "
            f"11, backbones); ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name](num_classes=num_classes, **kw)
