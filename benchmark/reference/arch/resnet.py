"""ResNet (arXiv:1512.03385, torchvision's v1.5 bottleneck with the stride
on the 3x3) in plain float32.

Parameters: `conv1` 7x7, `bn1`, blocks `layer{s}_{i}` with `conv1..3`,
`bn1..3` and, on each stage's first block, `downsample_conv` and
`downsample_bn`; the readout `head`.  The scale of each bottleneck's last
batch norm starts at the configuration's `residual_bn_scale` (small, as a
trained network's are; at 1 the training-mode forward at the initial
weights is so ill-conditioned that rounding its input to bf16 moves the
logits by tens of percent).

Forward: 7x7/2 convolution, batch norm, ReLU, 3x3/2 max pool, the
bottlenecks (1x1, 3x3, 1x1 x4, each followed by batch norm, with a 1x1
projection on each stage's first block), global average pool, head.
Batch norm (eps 1e-5) normalises by the batch's mean and biased variance
in training, by the given running statistics in evaluation.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from benchmark.reference import precision
from benchmark.reference.arch import conv
from benchmark.reference.layout import Leaf

BN_EPS = 1e-5
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4


def blocks(c: dict):
    """(name, in channels, width, stride, downsample) of every bottleneck."""
    out, cin = [], 64
    for s, (n, w) in enumerate(zip(c["stage_sizes"], WIDTHS)):
        for i in range(n):
            out.append((f"layer{s + 1}_{i}", cin, w,
                        2 if (s > 0 and i == 0) else 1, i == 0))
            cin = w * EXPANSION
    return out


def _bn_leaves(path, n, scale=1.0):
    return [Leaf(path + ("scale",), (n,), "const", value=scale),
            Leaf(path + ("bias",), (n,), "const")]


def leaves(c: dict) -> List[Leaf]:
    ch = c["num_channels"]
    out = [Leaf(("conv1", "kernel"), (7, 7, ch, 64), "fan_in"),
           *_bn_leaves(("bn1",), 64)]
    for name, cin, w, _, down in blocks(c):
        wide = w * EXPANSION
        out += [Leaf((name, "conv1", "kernel"), (1, 1, cin, w), "fan_in"),
                Leaf((name, "conv2", "kernel"), (3, 3, w, w), "fan_in"),
                Leaf((name, "conv3", "kernel"), (1, 1, w, wide), "fan_in"),
                *_bn_leaves((name, "bn1"), w), *_bn_leaves((name, "bn2"), w),
                *_bn_leaves((name, "bn3"), wide,
                            c.get("residual_bn_scale", 1.0))]
        if down:
            out += [Leaf((name, "downsample_conv", "kernel"),
                         (1, 1, cin, wide), "fan_in"),
                    *_bn_leaves((name, "downsample_bn"), wide)]
    last = WIDTHS[-1] * EXPANSION
    out += [Leaf(("head", "kernel"), (last, c["num_classes"]), "head"),
            Leaf(("head", "bias"), (c["num_classes"],), "const")]
    return out


def _bn(x, p, path, stats, train):
    scale, bias = p[path + ("scale",)], p[path + ("bias",)]
    if train:
        return F.batch_norm(x, None, None, scale, bias, training=True,
                            eps=BN_EPS)
    s = stats["/".join(path)]
    return F.batch_norm(x, s["mean"], s["var"], scale, bias, training=False,
                        eps=BN_EPS)


def _resnet(p, x, config, ops, bn):
    """The ResNet's logits, `bn(y, path)` its batch norm."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(bn(conv(x, p[("conv1", "kernel")], ops, 2, 3), ("bn1",)))
    x = F.max_pool2d(x, 3, 2, padding=1)
    for name, _, _, stride, down in blocks(config):
        y = F.relu(bn(conv(x, p[(name, "conv1", "kernel")], ops),
                      (name, "bn1")))
        y = F.relu(bn(conv(y, p[(name, "conv2", "kernel")], ops, stride, 1),
                      (name, "bn2")))
        y = bn(conv(y, p[(name, "conv3", "kernel")], ops), (name, "bn3"))
        identity = x
        if down:
            identity = bn(conv(x, p[(name, "downsample_conv", "kernel")],
                               ops, stride), (name, "downsample_bn"))
        x = F.relu(y + identity)
    x = x.mean(dim=(2, 3))
    return ops.mm(x, p[("head", "kernel")]) + p[("head", "bias")]


def forward(p, x, config, ops, stats=None, train=True):
    """Logits; `stats` {"a/b": {"mean", "var"}} for evaluation."""
    return _resnet(p, x, config, ops,
                   lambda y, path: _bn(y, p, path, stats, train))


@torch.no_grad()
def batch_stats(p, x, config):
    """{"a/b": {"mean", "var"}}: every batch norm's batch mean and biased
    variance in a training-mode forward of `x`, for an evaluation that
    normalises as the trained network would."""
    stats = {}

    def bn(y, path):
        stats["/".join(path)] = {"mean": y.mean((0, 2, 3)),
                                 "var": y.var((0, 2, 3), unbiased=False)}
        return _bn(y, p, path, None, True)

    _resnet(p, x, config, precision.Products("fp32"), bn)
    return stats
