"""Layers shared by the backbones, with flax's parameter names, layouts,
initialisers and numerics.

The modules hold no weights of their own: their parameters live on the
`meta` device and are only shapes.  Real weights come from `init_params`
and enter the forward as views of the flat vector, through
`torch.func.functional_call` (see core/prior.py).

Layouts follow the JAX package's flat vector: Dense kernels [in, out],
Conv kernels HWIO.  Activations are NCHW tensors laid out channels_last, so
an NHWC input becomes one by a `permute` and no copy.  A module built with
a half-precision `dtype` casts its input and weights to it, as flax's
`dtype=` does (a no-op where core/prior.py has cast θ already);
BatchNorm and LayerNorm take their statistics in fp32 whatever the dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# std of a standard normal truncated to [-2, 2]; flax divides by it so the
# truncated draw has the requested variance
_TRUNC_STD = 0.87962566103423978


def variance_scaling(shape, scale: float, generator: torch.Generator):
    """flax `variance_scaling(scale, "fan_in", "truncated_normal")`, with
    fan_in the product of all but the last axis: `in` for an [in, out]
    Dense kernel, kh * kw * in for an HWIO Conv kernel.  lecun_normal is
    scale 1, he_normal scale 2."""
    fan_in = int(np.prod(shape[:-1]))
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    w = torch.empty(shape, dtype=torch.float32)
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def stacked_variance_scaling(shape, scale: float,
                             generator: torch.Generator):
    """`variance_scaling` of a leaf with a leading layer axis, as flax's
    `nn.scan` initialises it: each layer's slice drawn with its own shape,
    so fan_in leaves the layer axis out (`in` for a [depth, in, out]
    kernel, not depth * in)."""
    return torch.stack([variance_scaling(shape[1:], scale, generator)
                        for _ in range(shape[0])])


def shape_only(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device="meta"))


def dense(x, kernel, bias, dt: torch.dtype):
    """flax nn.Dense: `x @ kernel + bias` in dt."""
    return x.to(dt) @ kernel.to(dt) + bias.to(dt)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    """flax nn.LayerNorm over the last axis with x's dtype as `dtype`: the
    statistics and the affine map in fp32 (flax promotes a half-precision
    input to fp32 for both), the output rounded to x's dtype.  The library
    kernel computes in fp32 for a half-precision x and leaves of its dtype;
    fp32 leaves under a half-precision x (per-leaf casts) go through fp32."""
    if scale.dtype == x.dtype:
        return F.layer_norm(x, (x.shape[-1],), scale, bias, eps)
    return F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                        bias.float(), eps).to(x.dtype)


class Dense(nn.Module):
    """flax nn.Dense: `x @ kernel + bias` in `dtype`.  With `depth`, the
    leaves carry a leading layer axis ([depth, in, out] and [depth, out]),
    the layout of a flax module under `nn.scan`; the owner applies one
    layer's slice with `dense`."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32, depth=None):
        super().__init__()
        self.dtype = dtype
        self.depth = depth
        lead = () if depth is None else (depth,)
        self.kernel = shape_only(*lead, in_features, out_features)
        self.bias = shape_only(*lead, out_features)

    def forward(self, x):
        return dense(x, self.kernel, self.bias, self.dtype)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(epsilon=1e-6): leaves `scale` and `bias` [features],
    or [depth, features] with `depth` (see Dense)."""

    def __init__(self, features: int, eps: float = 1e-6, depth=None):
        super().__init__()
        self.eps = eps
        lead = () if depth is None else (depth,)
        self.scale = shape_only(*lead, features)
        self.bias = shape_only(*lead, features)

    def forward(self, x):
        return layer_norm(x, self.scale, self.bias, self.eps)


class Conv(nn.Module):
    """flax nn.Conv with symmetric padding; the HWIO kernel is turned into a
    channels_last OIHW weight in `dtype` by one copy per forward."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 padding: int = 0, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.kernel = shape_only(k, k, in_ch, out_ch)
        if use_bias:
            self.bias = shape_only(out_ch)
        else:
            self.register_parameter("bias", None)

    def forward(self, x):
        dt = self.dtype
        w = self.kernel.permute(3, 2, 0, 1).to(
            dtype=dt, memory_format=torch.channels_last)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), w, b, self.stride, self.padding)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-5) over dim 1.

    forward(x, stats, train) -> (y, stats').  `stats` is {"mean", "var"},
    fp32 [C].  In train mode the batch's biased variance both normalises
    and updates the running variance, as flax does (torch's own running
    update uses the unbiased one, so it is written here under no_grad from
    the statistics the normalisation saved).  In eval mode the running
    averages normalise and `stats` comes back unchanged.  y has x's dtype;
    the statistics and the affine map are fp32.
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = shape_only(features)
        self.bias = shape_only(features)

    def forward(self, x, stats, train: bool):
        if not train:
            return F.batch_norm(x, stats["mean"], stats["var"], self.scale,
                                self.bias, training=False, eps=self.eps), stats
        # saves for backward what the library's batch norm saves: the input
        # and the per-channel mean and 1/std
        y, mean, invstd = torch.native_batch_norm(
            x, self.scale, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = torch.clamp(invstd.pow(-2) - self.eps, min=0.0)
            m = self.momentum
            new = {"mean": m * stats["mean"] + (1.0 - m) * mean,
                   "var": m * stats["var"] + (1.0 - m) * var}
        return y, new


def _put(tree: dict, path: str, leaf):
    *outer, last = path.split(".")
    node = tree
    for name in outer:
        node = node.setdefault(name, {})
    node[last] = leaf


def init_params(module: nn.Module, generator: torch.Generator,
                readout_name: str = "head") -> dict:
    """Fresh weights of every Dense, Conv, BatchNorm and LayerNorm in
    `module`, as a nested dict of CPU fp32 tensors keyed by module path,
    initialised as flax does: kernels lecun_normal (layer by layer for a
    stacked Dense), the readout's kernel he_normal, biases and norm shifts
    0, norm scales 1.  Draws follow the modules' registration order."""
    params: dict = {}
    for path, m in module.named_modules():
        if isinstance(m, (Dense, Conv)):
            scale = 2.0 if path == readout_name else 1.0
            draw = (variance_scaling if getattr(m, "depth", None) is None
                    else stacked_variance_scaling)
            leaf = {"kernel": draw(tuple(m.kernel.shape), scale, generator)}
            if m.bias is not None:
                leaf["bias"] = torch.zeros(tuple(m.bias.shape))
        elif isinstance(m, (BatchNorm, LayerNorm)):
            shape = tuple(m.scale.shape)
            leaf = {"scale": torch.ones(shape), "bias": torch.zeros(shape)}
        else:
            continue
        _put(params, path, leaf)
    return params


def init_batch_stats(module: nn.Module) -> dict:
    """flax's initial `batch_stats` collection: mean 0 and var 1 for every
    BatchNorm, nested by module path."""
    stats: dict = {}
    for path, m in module.named_modules():
        if isinstance(m, BatchNorm):
            n = m.scale.shape[0]
            _put(stats, path, {"mean": torch.zeros(n), "var": torch.ones(n)})
    return stats


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC (or NHW) input -> an NCHW view laid out channels_last."""
    if x.dim() == 3:
        x = x[..., None]
    return x.permute(0, 3, 1, 2)
