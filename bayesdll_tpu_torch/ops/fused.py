"""Sampler updates over the flat parameter vector (counterpart of
bayesdll_tpu.ops.fused).

`sgld_update`, `sghmc_update` and `csghmc_update` are the plain PyTorch
versions, with the JAX package's formulas and contracts; they are the
oracles the tests and chip_smoke.py hold the kernels against.  The
versions with a trailing underscore are what the runners call: on CUDA
tensors they launch the hand-written kernel (ops/kernels.py) and nothing
else; on CPU tensors they run the plain version.  The per-step path hands
them the seed, the step and csghmc's gate as host values; the fused path
hands them `dev`, an int64 tensor (seed, step, gate) on the vectors'
device, which the kernel's pointer entry point reads on the card (a
captured graph cannot take host values that change from step to step) and
which the CPU reads as the same three values.  `adam_sghmc_update` (and
its momentum, `adam_sghmc_momentum`) has no kernel in either package: it
is plain PyTorch on every device.

SGLD and SGHMC clamp the per-element lr at LR_FLOOR inside the noise scale
and the drift, as the Pallas kernels do (bayesdll_tpu/ops/pallas_kernels.py
`_sgld_kernel`, `_sghmc_kernel`).  That changes nothing where lr >= 1e-30;
where lr = 0 (a run with lr_head 0) the JAX package's default XLA path
gives NaN or inf, and the port stays finite.
"""

from __future__ import annotations

import numpy as np
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


def adam_sghmc_momentum(g, theta, theta0, v_mom, m, v2, t: int, prior_mask,
                        lr, *, prior_sig: float, n_eff: float, nd: float,
                        alpha: float, beta1: float, beta2: float,
                        eps_adam: float, temperature: float = 1.0, noise=None,
                        generator: torch.Generator | None = None):
    """Adam-preconditioned SGHMC momentum (reference
    `methods/adam_sghmc.py:508-553`; with a temperature,
    `methods/adam_csghmc.py:829-858`):

        grad_U = g / T + mask * (theta - theta0) / prior_sig^2 / N
        m'  = b1 m + (1-b1) grad_U;  v2' = b2 v2 + (1-b2) grad_U^2
        m^  = m' / (1 - b1^t);       v^  = v2' / (1 - b2^t)
        P   = 1 / (sqrt(v^) + eps)
        v_mom' = (1-alpha) v_mom + lr * m^ * P + nd * sqrt(2 alpha P / N) * z

    in the JAX package's operation order.  `t` is the already-incremented
    Adam step; b^t is taken in fp32, as the JAX package takes it on the
    device.  z is `noise` when given, else drawn from `generator`; at
    nd = 0 nothing is drawn.  Plain PyTorch on any device: the JAX package
    has no Pallas kernel for this update.  Returns new tensors
    (v_mom', m', v2')."""
    grad_u = g / temperature if temperature != 1.0 else g
    grad_u = grad_u + prior_mask * (theta - theta0) / (prior_sig ** 2) / n_eff
    m_new = beta1 * m + (1.0 - beta1) * grad_u
    v2_new = beta2 * v2 + (1.0 - beta2) * grad_u * grad_u
    tf = np.float32(t)
    bc1 = float(np.float32(1.0) - np.float32(beta1) ** tf)
    bc2 = float(np.float32(1.0) - np.float32(beta2) ** tf)
    precond = 1.0 / (torch.sqrt(v2_new / bc2) + eps_adam)
    v_new = (1.0 - alpha) * v_mom + lr * (m_new / bc1) * precond
    if nd != 0.0:
        v_new = v_new + nd * torch.sqrt(2.0 * alpha * precond / n_eff) \
            * _normal(g, noise, generator)
    return v_new, m_new, v2_new


def adam_sghmc_update(g, theta, theta0, v_mom, m, v2, t: int, prior_mask, lr,
                      **kw):
    """Adam-SGHMC's crafted gradient (counterpart of
    bayesdll_tpu.ops.fused.adam_sghmc_update): `adam_sghmc_momentum`, then
    g' = g + v_mom'.  SGD then applies lr a second time, as in SGHMC.
    Returns new tensors (g', v_mom', m', v2')."""
    v_new, m_new, v2_new = adam_sghmc_momentum(g, theta, theta0, v_mom, m, v2,
                                               t, prior_mask, lr, **kw)
    return g + v_new, v_new, m_new, v2_new


def _cpu_generator(t: torch.Tensor, name: str, seed: int, step: int):
    """The plain version's generator for (seed, step); anything but a CPU
    tensor raises."""
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no path for device {t.device}")
    return rng.generator("cpu", int(seed), rng.TRAIN_CPU, int(step))


def _host_scalars(dev, seed, step, gate=False):
    """(seed, step, gate): the host values, or those `dev` holds (read on
    the CPU, where reading waits on nothing)."""
    if dev is None:
        return seed, step, gate
    seed, step, gate = (int(x) for x in dev.tolist())
    return seed & kernels._U64, step, bool(gate)


def csghmc_update_(g, theta, v, *, prior_sig: float, n_eff: float, nd: float,
                   alpha: float, lr, should_sample: bool = False,
                   seed: int = 0, step: int = 0, dev=None):
    """csghmc_update IN PLACE on theta and v; the noise is a pure function of
    (seed, step).  CUDA tensors go to the kernel, which launches or raises;
    CPU tensors take the plain version.  `dev` (seed, step, gate), when
    given, stands for seed, step and should_sample."""
    if theta.is_cuda:
        pref = kernels.noise_prefactor(nd, alpha, n_eff)
        if dev is not None:
            return kernels.csghmc_update_dev(g, theta, v, lr, dev,
                                             prior_sig=prior_sig, alpha=alpha,
                                             noise_pref=pref)
        return kernels.csghmc_update(
            g, theta, v, lr, prior_sig=prior_sig, alpha=alpha,
            noise_pref=pref, gate=should_sample, seed=seed, step=step)
    seed, step, should_sample = _host_scalars(dev, seed, step, should_sample)
    th_new, v_new = csghmc_update(
        g, theta, v, prior_sig=prior_sig, n_eff=n_eff, nd=nd, alpha=alpha,
        lr=lr, should_sample=should_sample,
        generator=_cpu_generator(theta, "csghmc_update_", seed, step))
    theta.copy_(th_new)
    v.copy_(v_new)
    return theta, v


def sgld_update_(g, theta, theta0, prior_mask, lr, *, prior_sig: float,
                 n_eff: float, nd: float, seed: int = 0, step: int = 0,
                 dev=None):
    """sgld_update IN PLACE on g; the noise is a pure function of (seed,
    step).  CUDA tensors go to the kernel, which launches or raises; CPU
    tensors take the plain version.  `dev`, when given, stands for seed and
    step."""
    if g.is_cuda:
        if dev is not None:
            return kernels.sgld_update_dev(g, theta, theta0, prior_mask, lr,
                                           dev, prior_sig=prior_sig,
                                           n_eff=n_eff, nd=nd)
        return kernels.sgld_update(g, theta, theta0, prior_mask, lr,
                                   prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                                   seed=seed, step=step)
    seed, step, _ = _host_scalars(dev, seed, step)
    gen = _cpu_generator(g, "sgld_update_", seed, step)
    return g.copy_(sgld_update(g, theta, theta0, prior_mask, lr,
                               prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                               generator=gen))


def sghmc_update_(g, theta, theta0, v, prior_mask, lr, *, prior_sig: float,
                  n_eff: float, nd: float, alpha: float, seed: int = 0,
                  step: int = 0, dev=None):
    """sghmc_update IN PLACE on g and v, as sgld_update_ dispatches.
    Returns (g, v)."""
    if g.is_cuda:
        if dev is not None:
            return kernels.sghmc_update_dev(g, theta, theta0, v, prior_mask,
                                            lr, dev, prior_sig=prior_sig,
                                            n_eff=n_eff, nd=nd, alpha=alpha)
        return kernels.sghmc_update(g, theta, theta0, v, prior_mask, lr,
                                    prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                                    alpha=alpha, seed=seed, step=step)
    seed, step, _ = _host_scalars(dev, seed, step)
    gen = _cpu_generator(g, "sghmc_update_", seed, step)
    g_new, v_new = sghmc_update(g, theta, theta0, v, prior_mask, lr,
                                prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                                alpha=alpha, generator=gen)
    g.copy_(g_new)
    v.copy_(v_new)
    return g, v
