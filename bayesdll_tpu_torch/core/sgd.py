"""SGD with torch-SGD momentum over the flat vector (counterpart of
bayesdll_tpu.core.sgd).

SGLD, SGHMC and cSGLD write a crafted gradient and then take a torch-SGD
step (momentum mu, dampening 0, no nesterov):

    buf   <- grad               on the runner's first step (a clone of the
                                gradient, not zero)
    buf   <- mu * buf + grad    afterwards
    theta <- theta - lr * buf

Here the step runs IN PLACE on theta and buf.  `lr * buf` is rounded
before the subtraction, as the JAX package rounds it, so the card and the
CPU give the same bits (a fused multiply-add would not).
"""

from __future__ import annotations

import torch


def sgd_step(theta: torch.Tensor, grad: torch.Tensor, buf: torch.Tensor,
             lr, momentum: float, step: int):
    """One step; lr is a per-element vector or a scalar, step the runner's
    own step count (0 on its first call).  Returns (theta, buf), the same
    tensors, updated."""
    if momentum == 0.0:
        theta.sub_(lr * grad)
        return theta, buf
    if step == 0:
        buf.copy_(grad)
    else:
        buf.mul_(momentum).add_(grad)
    theta.sub_(lr * buf)
    return theta, buf
