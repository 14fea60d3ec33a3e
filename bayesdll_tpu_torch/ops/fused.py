"""Sampler updates over the flat parameter vector (counterpart of
bayesdll_tpu.ops.fused).

`csghmc_update` is the plain PyTorch version, with the JAX package's formula
and contract; it is the oracle the tests and chip_smoke.py hold the kernel
against.  `csghmc_update_` is what the runner calls: on CUDA tensors it
launches the hand-written kernel (ops/kernels.py) and nothing else; on CPU
tensors it runs the plain version.
"""

from __future__ import annotations

import torch

from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.ops import kernels


def csghmc_update(g, theta, v, *, prior_sig: float, n_eff: float, nd: float,
                  alpha: float, lr, should_sample: bool, noise=None,
                  generator: torch.Generator | None = None):
    """cSGHMC direct-write update (reference `methods/csghmc.py:756-778`):

        grad_U = g + prior_sig * theta
        v'     = (1 - alpha) * v - lr * grad_U
                 + [nd * sqrt(2 * alpha * lr) / N * z  if should_sample]
        theta' = theta + v'

    z is `noise` when given, else drawn from `generator`.  Returns new
    tensors (theta', v').
    """
    grad_u = g + prior_sig * theta
    v_new = (1.0 - alpha) * v - lr * grad_u
    if should_sample:
        if noise is None:
            noise = torch.randn(g.shape, generator=generator, dtype=g.dtype,
                                device=g.device)
        v_new = v_new + nd * torch.sqrt(2.0 * alpha * lr) / n_eff * noise
    return theta + v_new, v_new


def csghmc_update_(g, theta, v, *, prior_sig: float, n_eff: float, nd: float,
                   alpha: float, lr, should_sample: bool, seed: int,
                   step: int):
    """csghmc_update IN PLACE on theta and v; the noise is a pure function of
    (seed, step).  CUDA tensors go to the kernel, which launches or raises;
    CPU tensors take the plain version."""
    if theta.is_cuda:
        return kernels.csghmc_update(
            g, theta, v, lr, prior_sig=prior_sig, alpha=alpha,
            noise_pref=kernels.noise_prefactor(nd, alpha, n_eff),
            gate=should_sample, seed=seed, step=step)
    if theta.device.type != "cpu":
        raise ValueError(f"csghmc_update_: no path for device {theta.device}")
    th_new, v_new = csghmc_update(
        g, theta, v, prior_sig=prior_sig, n_eff=n_eff, nd=nd, alpha=alpha,
        lr=lr, should_sample=should_sample,
        generator=rng.generator("cpu", seed, rng.TRAIN_CPU, step))
    theta.copy_(th_new)
    v.copy_(v_new)
    return theta, v
