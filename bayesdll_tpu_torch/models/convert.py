"""torchvision state_dict -> the port's parameter tree (counterpart of
bayesdll_tpu.models.convert).

Pretrained torchvision weights serve as the prior mean: the prior copy gets
a ZEROED head, while the workhorse copy keeps a freshly initialised head
(reference `networks/__init__.py:66-98`).  Weights load from a local
`.pth`/`.pt` state_dict only (`torch.load(..., weights_only=True)`);
nothing is downloaded.  Layout transforms, to the JAX package's layout:
  * Conv OIHW -> HWIO
  * Linear [out, in] -> [in, out]
  * BatchNorm weight/bias -> scale/bias; running_mean/var -> batch_stats
  * ViT packed in_proj [3D, D] -> qkv kernel [D, 3D], every encoder-layer
    tensor stacked over depth (models/vit.py's scanned layout)
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from bayesdll_tpu_torch.core import flat as flat_util
from bayesdll_tpu_torch.models.resnet import STAGE_SIZES


def _load_state_dict(path: str) -> Dict[str, np.ndarray]:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"pretrained weights file '{path}' not found; provide a local "
            "torchvision state_dict (.pth): nothing is downloaded")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items()}


def _conv(w):   # OIHW -> HWIO
    return np.transpose(w, (2, 3, 1, 0))


def _linear(w):  # [out, in] -> [in, out]
    return np.transpose(w, (1, 0))


def resnet_params_from_torch(sd: Dict[str, np.ndarray], stage_sizes,
                             num_classes: int, zero_head: bool):
    """(params, batch_stats) nested numpy dicts for models/resnet.py::ResNet."""
    params: Dict = {}
    stats: Dict = {}

    def bn(torch_prefix: str):
        return ({"scale": sd[f"{torch_prefix}.weight"],
                 "bias": sd[f"{torch_prefix}.bias"]},
                {"mean": sd[f"{torch_prefix}.running_mean"],
                 "var": sd[f"{torch_prefix}.running_var"]})

    params["conv1"] = {"kernel": _conv(sd["conv1.weight"])}
    params["bn1"], stats["bn1"] = bn("bn1")
    for li, n_blocks in enumerate(stage_sizes):
        for bi in range(n_blocks):
            tp = f"layer{li + 1}.{bi}"
            bparams: Dict = {}
            bstats: Dict = {}
            for ci in (1, 2, 3):
                bparams[f"conv{ci}"] = {
                    "kernel": _conv(sd[f"{tp}.conv{ci}.weight"])}
                bparams[f"bn{ci}"], bstats[f"bn{ci}"] = bn(f"{tp}.bn{ci}")
            if f"{tp}.downsample.0.weight" in sd:
                bparams["downsample_conv"] = {
                    "kernel": _conv(sd[f"{tp}.downsample.0.weight"])}
                bparams["downsample_bn"], bstats["downsample_bn"] = bn(
                    f"{tp}.downsample.1")
            params[f"layer{li + 1}_{bi}"] = bparams
            stats[f"layer{li + 1}_{bi}"] = bstats

    # head: torchvision's `fc`, zeroed for the prior copy and wherever the
    # file's head does not fit the task
    if zero_head or "fc.weight" not in sd \
            or sd["fc.weight"].shape[0] != num_classes:
        params["head"] = {"kernel": np.zeros((2048, num_classes), np.float32),
                          "bias": np.zeros((num_classes,), np.float32)}
    else:
        params["head"] = {"kernel": _linear(sd["fc.weight"]),
                          "bias": sd["fc.bias"]}
    return params, stats


def vit_params_from_torch(sd: Dict[str, np.ndarray], depth: int, dim: int,
                          num_classes: int, zero_head: bool):
    """(params, {}) nested numpy dicts for models/vit.py::ViT: torchvision's
    per-layer encoder tensors stacked along a leading depth axis."""
    def stacked(fmt, transform=lambda a: a):
        return np.stack([transform(sd[fmt.format(i=i)]) for i in range(depth)])

    tp = "encoder.layers.encoder_layer_{i}"
    params: Dict = {
        "conv_proj": {"kernel": _conv(sd["conv_proj.weight"]),
                      "bias": sd["conv_proj.bias"]},
        "class_token": sd["class_token"].reshape(1, 1, dim),
        "pos_embedding": sd["encoder.pos_embedding"],
        "layers": {
            "ln_1": {"scale": stacked(tp + ".ln_1.weight"),
                     "bias": stacked(tp + ".ln_1.bias")},
            "attention": {
                "qkv": {"kernel": stacked(
                            tp + ".self_attention.in_proj_weight", _linear),
                        "bias": stacked(tp + ".self_attention.in_proj_bias")},
                "out": {"kernel": stacked(
                            tp + ".self_attention.out_proj.weight", _linear),
                        "bias": stacked(tp + ".self_attention.out_proj.bias")},
            },
            "ln_2": {"scale": stacked(tp + ".ln_2.weight"),
                     "bias": stacked(tp + ".ln_2.bias")},
            "mlp_dense_0": {"kernel": stacked(tp + ".mlp.0.weight", _linear),
                            "bias": stacked(tp + ".mlp.0.bias")},
            "mlp_dense_1": {"kernel": stacked(tp + ".mlp.3.weight", _linear),
                            "bias": stacked(tp + ".mlp.3.bias")},
        },
        "ln": {"scale": sd["encoder.ln.weight"], "bias": sd["encoder.ln.bias"]},
    }
    # head: torchvision's `heads.head`, zeroed as the ResNet's `fc` is
    if zero_head or "heads.head.weight" not in sd \
            or sd["heads.head.weight"].shape[0] != num_classes:
        params["head"] = {"kernel": np.zeros((dim, num_classes), np.float32),
                          "bias": np.zeros((num_classes,), np.float32)}
    else:
        params["head"] = {"kernel": _linear(sd["heads.head.weight"]),
                          "bias": sd["heads.head.bias"]}
    return params, {}


_ARCH = {
    "resnet101": dict(kind="resnet", stage_sizes=STAGE_SIZES["resnet101"]),
    "resnet50": dict(kind="resnet", stage_sizes=STAGE_SIZES["resnet50"]),
    "vit_l_32": dict(kind="vit", depth=24, dim=1024),
    "vit_b_16": dict(kind="vit", depth=12, dim=768),
}


def _convert(path: str, backbone: str, num_classes: int, zero_head: bool):
    if backbone not in _ARCH:
        raise NotImplementedError(
            f"pretrained conversion not implemented for '{backbone}'; "
            f"known: {sorted(_ARCH)}")
    a = _ARCH[backbone]
    sd = _load_state_dict(path)
    if a["kind"] == "resnet":
        return resnet_params_from_torch(sd, a["stage_sizes"], num_classes,
                                        zero_head)
    return vit_params_from_torch(sd, a["depth"], a["dim"], num_classes,
                                 zero_head)


def load_pretrained_params(path: str, backbone: str, num_classes: int,
                           zero_head: bool = True):
    """Parameter tree with the pretrained body and a zeroed (or, where the
    file's head does not fit the task, zero) head: the prior-mean copy."""
    return _convert(path, backbone, num_classes, zero_head)[0]


def load_pretrained_batch_stats(path: str, backbone: str):
    """The `batch_stats` collection from the file's running statistics ({}
    for a ViT, which has none: its file is not read)."""
    if _ARCH.get(backbone, {}).get("kind") == "vit":
        return {}
    return _convert(path, backbone, 1, zero_head=True)[1]


def pretrained_workhorse_theta(path: str, backbone: str, target, theta_init,
                               num_classes: int) -> torch.Tensor:
    """Flat θ of the workhorse: the pretrained body and the RANDOM head of
    theta_init (reference `networks/__init__.py:93-98`), on theta_init's
    device and padded as theta_init is."""
    pre = load_pretrained_params(path, backbone, num_classes, zero_head=True)
    theta_pre = flat_util.flatten_params(pre)[0].to(theta_init.device)
    # the padding stays theta_init's
    theta_pre = torch.cat([theta_pre, theta_init[theta_pre.shape[0]:]])
    # head elements (the head bias too) come from the random init; the
    # pretrained copy's head is zero anyway
    return torch.where(target.is_head, theta_init, theta_pre)
