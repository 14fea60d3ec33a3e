"""Small convolutional backbone for MNIST-scale tasks (counterpart of
bayesdll_tpu.models.cnn): two 3x3 conv + relu + 2x2 average-pool stages,
a 256-unit Dense and the readout ``head``.  No batch statistics.

The flatten before `dense_0` runs over NHWC, as the flax module's does, so
the rows of `dense_0`'s kernel are in (h, w, c) order; an NCHW flatten
would permute them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bayesdll_tpu_torch.models.layers import Conv, Dense, init_params, to_nchw


class SmallCNN(nn.Module):
    def __init__(self, num_classes: int = 10, channels: int = 32,
                 input_hw: int = 28, dtype: str = "float32"):
        super().__init__()
        dt = getattr(torch, dtype)
        self.dtype = dt
        c = channels
        self.conv_0 = Conv(1, c, 3, padding=1, use_bias=True, dtype=dt)
        self.conv_1 = Conv(c, 2 * c, 3, padding=1, use_bias=True, dtype=dt)
        side = input_hw // 4
        self.dense_0 = Dense(2 * c * side * side, 256, dtype=dt)
        self.head = Dense(256, num_classes, dtype=dt)

    def forward(self, x):
        x = to_nchw(x).to(self.dtype)
        x = F.avg_pool2d(F.relu(self.conv_0(x)), 2)
        x = F.avg_pool2d(F.relu(self.conv_1(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # NHWC flatten
        x = F.relu(self.dense_0(x))
        return self.head(x).float()

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh weights as flax initialises them: kernels lecun_normal,
        the head he_normal, biases zero."""
        return init_params(self, generator)
