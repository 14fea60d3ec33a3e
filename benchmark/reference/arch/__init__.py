"""The reference's architectures, one module each, found by a
configuration's `architecture`: `benchmark/reference/arch/<name>.py`.

Each module gives
  * `leaves(config)`: the parameters as the flat vector holds them
    (layout.Leaf: path, shape, how the benchmark draws it, whether it is
    stacked over depth);
  * `forward(p, x, config, ops, stats=None, train=True)`: plain float32
    logits from the vector's views `p` ({path: tensor}) and NHWC float32
    images `x`, every product and convolution through `ops`
    (precision.Products);
and, where the network keeps running statistics, `batch_stats(p, x,
config)`: {"a/b": {"mean", "var"}} of a training-mode forward of `x`.
"""

from __future__ import annotations

import importlib


def module(config: dict):
    """The module of the configuration's architecture."""
    return importlib.import_module(f"{__name__}.{config['architecture']}")


def conv(x, kernel_hwio, ops, stride=1, padding=0, bias=None):
    """An NCHW convolution by an HWIO kernel, as the vector stores them."""
    return ops.conv(x, kernel_hwio.permute(3, 2, 0, 1), stride, padding,
                    bias)
