"""The precision the reference computes its products in (`Products`).

"fp32" is the reference itself: every product and convolution in float32
with TF32 off (`fp32_products`).  "fp8" is the benchmark's control, the
precision one step below the bf16 that the configurations state, as fp8
training runs: the inputs of every product and convolution (activations
and weights alike) rounded to float8 e4m3 in the forward pass, and the
gradient of each product's output rounded to float8 e5m2 in the backward
pass, each with one scale per tensor (its largest magnitude to the
format's largest finite value), the sums in float32, as an fp8 matrix unit
computes them.  Everything between the products stays float32.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


@contextlib.contextmanager
def fp32_products():
    """float32 products and convolutions with TF32 off, restored after."""
    cuda_mm = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_mm
        torch.backends.cudnn.allow_tf32 = cudnn


def _round(x, fmt, fmax):
    """x rounded to the float8 format `fmt` under a per-tensor scale."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / fmax
    return (x / scale).to(fmt).to(x.dtype) * scale


class _Fp8Input(torch.autograd.Function):
    """A product's input rounded to e4m3; its gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8OutputGrad(torch.autograd.Function):
    """The identity on a product's output; the gradient that comes back
    into the product rounded to e5m2, so that both of its backward
    products (input and weight gradients) take fp8 operands."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Products:
    """Matrix products and convolutions in the reference's precision."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"precision: 'fp32' or 'fp8', got {precision!r}")
        self.fp8 = precision == "fp8"

    def _in(self, x):
        return _Fp8Input.apply(x) if self.fp8 else x

    def _out(self, y):
        return _Fp8OutputGrad.apply(y) if self.fp8 else y

    def mm(self, a, b):
        return self._out(self._in(a) @ self._in(b))

    def conv(self, x, w, stride=1, padding=0, bias=None):
        """x NCHW, w OIHW."""
        return self._out(F.conv2d(self._in(x.contiguous()),
                                  self._in(w.contiguous()), bias, stride,
                                  padding))
