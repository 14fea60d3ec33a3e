"""ResNet (bottleneck) backbones, torchvision-v1 structure (counterpart of
bayesdll_tpu.models.resnet).

Module and leaf names follow the JAX package's flax tree: `conv1`, `bn1`,
`layer{1..4}_{i}` with `conv1..3`, `bn1..3`, `downsample_conv` and
`downsample_bn`, and the readout `head` (torchvision's `fc`); leaves
`kernel`, `scale` and `bias`.  The sorted-key flat layout (core/flat.py)
is therefore the JAX package's, element for element.

The forward takes the NHWC batch and the nested `batch_stats` collection
and returns (fp32 logits, batch_stats'): in train mode the updated running
averages, in eval mode the ones it was given.  With dtype bfloat16 the
convolutions, the pooling and the head run in bf16 on bf16 weights cast
from the fp32 flat vector leaf by leaf, BatchNorm takes its statistics in
fp32 and returns bf16, and the logits come back fp32, as the flax module
computes them.  The casts are written out in the layers, not left to
`torch.autocast`, whose choices per operation differ from flax's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bayesdll_tpu_torch.models.layers import (BatchNorm, Conv, Dense,
                                              init_batch_stats, init_params,
                                              to_nchw)

WIDTHS = (64, 128, 256, 512)
# bottlenecks per stage of each registered depth
STAGE_SIZES = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 -> 3x3 (stride) -> 1x1 (x4) + residual."""

    def __init__(self, in_ch: int, width: int, stride: int, downsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        out_ch = width * 4
        self.conv1 = Conv(in_ch, width, 1, dtype=dtype)
        self.bn1 = BatchNorm(width)
        self.conv2 = Conv(width, width, 3, stride, padding=1, dtype=dtype)
        self.bn2 = BatchNorm(width)
        self.conv3 = Conv(width, out_ch, 1, dtype=dtype)
        self.bn3 = BatchNorm(out_ch)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv(in_ch, out_ch, 1, stride, dtype=dtype)
            self.downsample_bn = BatchNorm(out_ch)

    def forward(self, x, stats, train: bool):
        new = {}
        y, new["bn1"] = self.bn1(self.conv1(x), stats["bn1"], train)
        y, new["bn2"] = self.bn2(self.conv2(F.relu(y)), stats["bn2"], train)
        y, new["bn3"] = self.bn3(self.conv3(F.relu(y)), stats["bn3"], train)
        identity = x
        if self.downsample:
            identity, new["downsample_bn"] = self.downsample_bn(
                self.downsample_conv(x), stats["downsample_bn"], train)
        return F.relu(y + identity), new


class ResNet(nn.Module):
    # the flat vector stays fp32 and each layer casts its own leaves, as the
    # JAX package's ResNet asks (its `prefer_half_flat = False`)
    prefer_half_flat = False

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 dtype: str = "float32"):
        super().__init__()
        dt = getattr(torch, dtype)
        self.dtype = dt
        self.conv1 = Conv(3, 64, 7, 2, padding=3, dtype=dt)
        self.bn1 = BatchNorm(64)
        self.blocks = []
        in_ch = 64
        for li, (n_blocks, w) in enumerate(zip(stage_sizes, WIDTHS)):
            for bi in range(n_blocks):
                stride = 2 if (li > 0 and bi == 0) else 1
                name = f"layer{li + 1}_{bi}"
                # the first block of every stage changes the channels
                self.add_module(name, Bottleneck(in_ch, w, stride, bi == 0, dt))
                self.blocks.append(name)
                in_ch = w * 4
        self.head = Dense(in_ch, num_classes, dtype=dt)

    def forward(self, x, batch_stats, train: bool = False):
        new = {}
        x = to_nchw(x).to(self.dtype)
        x, new["bn1"] = self.bn1(self.conv1(x), batch_stats["bn1"], train)
        x = F.max_pool2d(F.relu(x), 3, 2, padding=1)
        for name in self.blocks:
            x, new[name] = getattr(self, name)(x, batch_stats[name], train)
        x = x.mean(dim=(2, 3))  # global average pool
        return self.head(x).float(), new

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh weights as flax initialises them: conv kernels
        lecun_normal, BatchNorm scale 1 and bias 0, the head he_normal with
        a zero bias."""
        return init_params(self, generator)

    def init_batch_stats(self) -> dict:
        return init_batch_stats(self)
