"""Sampler updates over the flat parameter vector (counterpart of
bayesdll_tpu.ops.fused).

`sgld_update`, `sghmc_update` and `csghmc_update` are the plain PyTorch
versions, with the JAX package's formulas and contracts; they are the
oracles the tests and chip_smoke.py hold the kernels against.  The
versions with a trailing underscore are what the runners call: on CUDA
tensors they launch the hand-written kernel (ops/kernels.py) and nothing
else; on CPU tensors they run the plain version.

SGLD and SGHMC clamp the per-element lr at LR_FLOOR inside the noise scale
and the drift, as the Pallas kernels do (bayesdll_tpu/ops/pallas_kernels.py
`_sgld_kernel`, `_sghmc_kernel`).  That changes nothing where lr >= 1e-30;
where lr = 0 (a run with lr_head 0) the JAX package's default XLA path
gives NaN or inf, and the port stays finite.
"""

from __future__ import annotations

import torch

from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.ops import kernels

LR_FLOOR = 1e-30


def _normal(like, noise, generator):
    if noise is not None:
        return noise
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def sgld_update(g, theta, theta0, prior_mask, lr, *, prior_sig: float,
                n_eff: float, nd: float, noise=None,
                generator: torch.Generator | None = None):
    """SGLD crafted gradient (reference `methods/sgld.py:468-484`):

        g' = g + mask * (theta - theta0) / prior_sig^2 / N
               + nd * sqrt(2 / (N * max(lr, 1e-30))) * z

    in the JAX package's XLA operation order.  z is `noise` when given,
    else drawn from `generator`; at nd = 0 nothing is drawn.  Returns a new
    tensor g'.
    """
    out = g + prior_mask * (theta - theta0) / (prior_sig ** 2) / n_eff
    if nd == 0.0:
        return out
    lr = torch.clamp(lr, min=LR_FLOOR)
    return out + nd * torch.sqrt(2.0 / (n_eff * lr)) * _normal(g, noise, generator)


def sghmc_update(g, theta, theta0, v, prior_mask, lr, *, prior_sig: float,
                 n_eff: float, nd: float, alpha: float, noise=None,
                 generator: torch.Generator | None = None):
    """SGHMC momentum update (reference `methods/sghmc.py:494-510`):

        grad_U = g + mask * (theta - theta0) / prior_sig^2 / N
        v'     = (1 - alpha) * v + lr * grad_U
                 + nd * sqrt(2 * alpha / (N * lr)) * z,   lr >= 1e-30
        g'     = g + v'

    SGD then applies lr a second time: the reference's double-lr quirk,
    kept.  Returns new tensors (g', v').
    """
    lr = torch.clamp(lr, min=LR_FLOOR)
    grad_u = g + prior_mask * (theta - theta0) / (prior_sig ** 2) / n_eff
    v_new = (1.0 - alpha) * v + lr * grad_u
    if nd != 0.0:
        v_new = v_new + nd * torch.sqrt(2.0 * alpha / (n_eff * lr)) \
            * _normal(g, noise, generator)
    return g + v_new, v_new


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
        v_new = v_new + nd * torch.sqrt(2.0 * alpha * lr) / n_eff \
            * _normal(g, noise, generator)
    return theta + v_new, v_new


def _cpu_generator(t: torch.Tensor, name: str, seed: int, step: int):
    """The plain version's generator for (seed, step); anything but a CPU
    tensor raises."""
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no path for device {t.device}")
    return rng.generator("cpu", seed, rng.TRAIN_CPU, step)


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
    th_new, v_new = csghmc_update(
        g, theta, v, prior_sig=prior_sig, n_eff=n_eff, nd=nd, alpha=alpha,
        lr=lr, should_sample=should_sample,
        generator=_cpu_generator(theta, "csghmc_update_", seed, step))
    theta.copy_(th_new)
    v.copy_(v_new)
    return theta, v


def sgld_update_(g, theta, theta0, prior_mask, lr, *, prior_sig: float,
                 n_eff: float, nd: float, seed: int, step: int):
    """sgld_update IN PLACE on g; the noise is a pure function of (seed,
    step).  CUDA tensors go to the kernel, which launches or raises; CPU
    tensors take the plain version."""
    if g.is_cuda:
        return kernels.sgld_update(g, theta, theta0, prior_mask, lr,
                                   prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                                   seed=seed, step=step)
    gen = _cpu_generator(g, "sgld_update_", seed, step)
    return g.copy_(sgld_update(g, theta, theta0, prior_mask, lr,
                               prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                               generator=gen))


def sghmc_update_(g, theta, theta0, v, prior_mask, lr, *, prior_sig: float,
                  n_eff: float, nd: float, alpha: float, seed: int,
                  step: int):
    """sghmc_update IN PLACE on g and v, as sgld_update_ dispatches.
    Returns (g, v)."""
    if g.is_cuda:
        return kernels.sghmc_update(g, theta, theta0, v, prior_mask, lr,
                                    prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                                    alpha=alpha, seed=seed, step=step)
    gen = _cpu_generator(g, "sghmc_update_", seed, step)
    g_new, v_new = sghmc_update(g, theta, theta0, v, prior_mask, lr,
                                prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                                alpha=alpha, generator=gen)
    g.copy_(g_new)
    v.copy_(v_new)
    return g, v
