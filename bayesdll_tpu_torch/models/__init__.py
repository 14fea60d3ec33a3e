"""Backbone registry (counterpart of bayesdll_tpu.models).

`create_backbone(name, num_classes, dtype=..., **kw)` returns `(module,
input_shape, meta)` with meta's `has_batch_stats` and `has_dropout` flags.
Every backbone names its readout submodule ``head`` so that
`core/flat.path_masks` finds the head parameters.  The ViT factories also
take the JAX factories' `remat`, `remat_policy`, `fused_attention` and
`gelu_approx`; the other backbones ignore them.  Building
a backbone allocates no weights (models/layers.py), so the data pipeline
builds one just to read its input shape.
"""

from __future__ import annotations

from typing import Tuple

from bayesdll_tpu_torch.models.cnn import SmallCNN
from bayesdll_tpu_torch.models.mlp import MLP
from bayesdll_tpu_torch.models.resnet import STAGE_SIZES, ResNet
from bayesdll_tpu_torch.models.vit import ARCHS as VIT_ARCHS
from bayesdll_tpu_torch.models.vit import ViT

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
                activation=kw.get("activation", "relu"), input_dim=784,
                dtype=kw.get("dtype", "float32"))
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


def _vit(name, num_classes, kw):
    arch = VIT_ARCHS[name]
    model = ViT(**arch, num_classes=num_classes,
                dtype=kw.get("dtype", "float32"),
                remat=bool(kw.get("remat", False)),
                remat_policy=kw.get("remat_policy", ""),
                fused_attention=bool(kw.get("fused_attention", True)),
                gelu_approx=bool(kw.get("gelu_approx", False)))
    side = arch["image_size"]
    return model, (side, side, 3), {"has_batch_stats": False,
                                    "has_dropout": False}


@register("vit_l_32")
def _vit_l_32(num_classes: int = 1000, **kw):
    return _vit("vit_l_32", num_classes, kw)


@register("vit_b_16")
def _vit_b_16(num_classes: int = 1000, **kw):
    return _vit("vit_b_16", num_classes, kw)


@register("vit_tiny")
def _vit_tiny(num_classes: int = 10, **kw):
    return _vit("vit_tiny", num_classes, kw)


def create_backbone(name: str, num_classes: int = 10, **kw) -> Tuple:
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"backbone '{name}' is not in the port (every backbone the JAX "
            f"package registers is; see ROADMAP.md); ported: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](num_classes=num_classes, **kw)
