"""Plain MLP backbone (counterpart of bayesdll_tpu.models.mlp).

`depth` hidden Dense layers of `width` units with relu/tanh, then a readout
Dense named ``head``.  Dense kernels are stored [in, out] and applied as
`x @ kernel + bias`, the flax layout, so the flat vector matches the JAX
package's element for element.

The module holds no weights of its own: its parameters live on the `meta`
device and are only shapes.  Real weights come from `init_params` and enter
the forward through `torch.func.functional_call` (see core/prior.py).
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a standard normal truncated to [-2, 2]; flax divides by it so the
# truncated draw has the requested variance
_TRUNC_STD = 0.87962566103423978


def _variance_scaling(shape, scale: float, generator: torch.Generator):
    """flax `variance_scaling(scale, "fan_in", "truncated_normal")` for an
    [in, out] kernel: lecun_normal is scale 1, he_normal scale 2."""
    std = math.sqrt(scale / shape[0]) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32)
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.empty(in_features, out_features, device="meta"))
        self.bias = nn.Parameter(torch.empty(out_features, device="meta"))

    def forward(self, x):
        return x @ self.kernel + self.bias


class MLP(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 1000,
                 depth: int = 3, activation: str = "relu",
                 input_dim: int = 784):
        super().__init__()
        self.depth = depth
        self.act = torch.tanh if activation == "tanh" else torch.relu
        dims = [input_dim] + [width] * depth
        for i in range(depth):
            self.add_module(f"layers_{i}", Dense(dims[i], dims[i + 1]))
        self.head = Dense(dims[-1], num_classes)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.depth):
            x = self.act(getattr(self, f"layers_{i}")(x))
        return self.head(x)

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh weights as a nested dict of CPU fp32 tensors, initialised
        as flax does: hidden kernels lecun_normal, the head kernel
        he_normal, biases zero."""
        params = {}
        for name, layer in self.named_children():
            scale = 2.0 if name == "head" else 1.0
            params[name] = {
                "kernel": _variance_scaling(tuple(layer.kernel.shape), scale,
                                            generator),
                "bias": torch.zeros(tuple(layer.bias.shape)),
            }
        return params
