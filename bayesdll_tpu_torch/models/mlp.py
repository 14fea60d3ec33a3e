"""Plain MLP backbone (counterpart of bayesdll_tpu.models.mlp).

`depth` hidden Dense layers of `width` units with relu/tanh, then a readout
Dense named ``head``.  Dense kernels are stored [in, out] and applied as
`x @ kernel + bias`, the flax layout, so the flat vector matches the JAX
package's element for element (models/layers.py).  With a half-precision
`dtype` the layers run in it and the logits come back fp32, as flax's
mixed precision computes them.
"""

from __future__ import annotations

import torch
from torch import nn

from bayesdll_tpu_torch.models.layers import Dense, init_params


class MLP(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 1000,
                 depth: int = 3, activation: str = "relu",
                 input_dim: int = 784, dtype: str = "float32"):
        super().__init__()
        dt = getattr(torch, dtype)
        self.dtype = dt
        self.depth = depth
        self.act = torch.tanh if activation == "tanh" else torch.relu
        dims = [input_dim] + [width] * depth
        for i in range(depth):
            self.add_module(f"layers_{i}", Dense(dims[i], dims[i + 1], dt))
        self.head = Dense(dims[-1], num_classes, dt)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.depth):
            x = self.act(getattr(self, f"layers_{i}")(x))
        return self.head(x).float()

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh weights as flax initialises them: hidden kernels
        lecun_normal, the head kernel he_normal, biases zero."""
        return init_params(self, generator)
