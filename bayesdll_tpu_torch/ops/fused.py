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
is plain PyTorch on every device, in place on the Adam state.  `draw_` is
the whole-vector draw of VI, MC-dropout and the Adam momentum noise: the
philox_draw kernel on the card, a host generator keyed by (seed, stream,
step) on the CPU.

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
from bayesdll_tpu_torch.core.moments import div_as_host_scalar
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


def adam_bias_corrections(t: int, beta1: float, beta2: float):
    """(1 - b1^t, 1 - b2^t) for the already-incremented Adam step t, taken
    in fp32 as the JAX package takes them on the device, as host floats."""
    tf = np.float32(t)
    return (float(np.float32(1.0) - np.float32(beta1) ** tf),
            float(np.float32(1.0) - np.float32(beta2) ** tf))


def _div_bc(x, bc):
    """x / bc, bc a host float or a 0-d tensor holding the same fp32 value,
    with the same bits either way."""
    if isinstance(bc, torch.Tensor):
        return div_as_host_scalar(x, bc)
    return x / bc


def adam_sghmc_momentum(g, theta, theta0, v_mom, m, v2, t: int, prior_mask,
                        lr, *, prior_sig: float, n_eff: float, nd: float,
                        alpha: float, beta1: float, beta2: float,
                        eps_adam: float, temperature: float = 1.0, noise=None,
                        generator: torch.Generator | None = None, bc=None):
    """Adam-preconditioned SGHMC momentum, IN PLACE on v_mom, m and v2
    (reference `methods/adam_sghmc.py:508-553`; with a temperature,
    `methods/adam_csghmc.py:829-858`):

        grad_U = g / T + mask * (theta - theta0) / prior_sig^2 / N
        m'  = b1 m + (1-b1) grad_U;  v2' = b2 v2 + (1-b2) grad_U^2
        m^  = m' / (1 - b1^t);       v^  = v2' / (1 - b2^t)
        P   = 1 / (sqrt(v^) + eps)
        v_mom' = (1-alpha) v_mom + lr * m^ * P + nd * sqrt(2 alpha P / N) * z

    in the JAX package's operation order.  `t` is the already-incremented
    Adam step; the bias corrections are `adam_bias_corrections(t)`, or `bc`
    where given: the pair as 0-d fp32 tensors on the vectors' device (the
    fused path, whose captured step cannot take them from the host), which
    divide with the host floats' bits.  z is `noise` when given, else drawn
    from `generator`; at nd = 0 nothing is drawn.  Plain PyTorch on any
    device: the JAX package has no Pallas kernel for this update.  Each of
    v_mom, m and v2 is written by its last sum (the bits of the
    out-of-place form), so a captured graph of the step reads and writes
    the state's own addresses.  Returns (v_mom, m, v2)."""
    grad_u = g / temperature if temperature != 1.0 else g
    grad_u = grad_u + prior_mask * (theta - theta0) / (prior_sig ** 2) / n_eff
    torch.add(beta1 * m, (1.0 - beta1) * grad_u, out=m)
    torch.add(beta2 * v2, (1.0 - beta2) * grad_u * grad_u, out=v2)
    bc1, bc2 = adam_bias_corrections(t, beta1, beta2) if bc is None else bc
    precond = 1.0 / (torch.sqrt(_div_bc(v2, bc2)) + eps_adam)
    decayed, drift = (1.0 - alpha) * v_mom, lr * _div_bc(m, bc1) * precond
    if nd == 0.0:
        torch.add(decayed, drift, out=v_mom)
    else:
        torch.add(decayed + drift, nd * torch.sqrt(
            2.0 * alpha * precond / n_eff) * _normal(g, noise, generator),
            out=v_mom)
    return v_mom, m, v2


def adam_sghmc_update(g, theta, theta0, v_mom, m, v2, t: int, prior_mask, lr,
                      **kw):
    """Adam-SGHMC's crafted gradient (counterpart of
    bayesdll_tpu.ops.fused.adam_sghmc_update): `adam_sghmc_momentum`, then
    g' = g + v_mom'.  SGD then applies lr a second time, as in SGHMC.
    Returns (g', v_mom, m, v2): g' a new tensor, the others updated in
    place."""
    v_new, m_new, v2_new = adam_sghmc_momentum(g, theta, theta0, v_mom, m, v2,
                                               t, prior_mask, lr, **kw)
    return g + v_new, v_new, m_new, v2_new


def _cpu_generator(t: torch.Tensor, name: str, seed: int, step: int):
    """The plain version's generator for (seed, step); anything but a CPU
    tensor raises."""
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no path for device {t.device}")
    return rng.generator("cpu", int(seed), rng.TRAIN_CPU, int(step))


_M32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(high, low) 32-bit words of a * b, a a 32-bit constant and b int64
    holding 32-bit values, without passing 2^63: b in 16-bit halves."""
    t1 = a * (b & 0xFFFF)
    mid = a * (b >> 16) + (t1 >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (t1 & 0xFFFF)


def philox4x32_10(x, y, z, w, key0: int, key1: int):
    """Philox4x32-10 (Salmon et al., SC'11) of the counters (x, y, z, w),
    int64 tensors of 32-bit values (or ints), under the key (key0, key1):
    csrc/normal_from_bits.cuh::philox4x32_10 in integer tensor ops."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(0xD2511F53, x)
        hi1, lo1 = _mulhilo(0xCD9E8D57, z)
        x, y, z, w = hi1 ^ y ^ key0, lo1, hi0 ^ w ^ key1, lo0
        key0 = (key0 + 0x9E3779B9) & _M32
        key1 = (key1 + 0xBB67AE85) & _M32
    return x, y, z, w


def philox_draw_plain(n: int, *, kind: str, stream: int, seed: int,
                      step: int, device="cpu", offset: int = 0):
    """The plain version of the philox_draw kernel: elements [offset, offset
    + n) (offset a multiple of 4) of its draw at (seed, step, stream), with
    its counter layout, its 24-bit uniforms (bit for bit) and its
    Box-Muller, here in float64 from the same uniforms and rounded to fp32
    (so the kernel's fp32 logf, sqrtf and sincospif differ by rounding
    only).  Integer tensor ops, as slow as they are plain: a yardstick, not
    a path."""
    if offset % 4:
        raise ValueError(f"offset {offset} is not a multiple of 4")
    seed, step = int(seed) & kernels._U64, int(step) & kernels._U64
    quads = torch.arange(offset // 4, (offset + n + 3) // 4,
                         dtype=torch.int64, device=device)
    words = philox4x32_10(quads, step & _M32, int(stream), step >> 32,
                          seed & _M32, seed >> 32)
    u = [((b >> 8).float() * (1.0 / 16777216.0)) for b in words]
    if kind == "uniform":
        out = torch.stack(u, 1)
    elif kind == "normal":
        z = []
        for u1, u2 in ((u[0], u[1]), (u[2], u[3])):
            r = torch.sqrt(-2.0 * torch.log(
                torch.clamp(u1, min=np.float32(1e-7)).double()))
            angle = 2.0 * np.pi * u2.double()
            z += [(r * torch.cos(angle)).float(),
                  (r * torch.sin(angle)).float()]
        out = torch.stack(z, 1)
    else:
        raise ValueError(f"kind: one of {sorted(kernels.DRAW_KINDS)}, got "
                         f"{kind!r}")
    return out.reshape(-1)[:n]


# the host generator's stream for each of philox_draw's streams
_HOST_STREAM = {kernels.STREAM_VI: rng.VI, kernels.STREAM_ADAM: rng.ADAM,
                kernels.STREAM_MC_DROPOUT: rng.MC_DROPOUT}


def draw_(like, *, kind: str, stream: int, seed: int = 0, step: int = 0,
          dev=None):
    """A new fp32 vector shaped as `like` (1-D) of N(0, 1) (kind "normal")
    or U[0, 1) (kind "uniform") draws, a pure function of (seed, step,
    stream), `stream` one of kernels.DRAW_STREAMS.  On a CUDA tensor the
    philox_draw kernel, which launches or raises; on a CPU tensor the plain
    version, torch.randn or torch.rand from the generator keyed by (seed,
    the stream's host stream, step).  The two give other bits of the same
    distribution.  `dev` (seed, step, gate), when given, stands for seed
    and step."""
    if like.is_cuda:
        if dev is not None:
            return kernels.philox_draw_dev(like, dev, kind=kind, stream=stream)
        return kernels.philox_draw(like, kind=kind, stream=stream, seed=seed,
                                   step=step)
    if like.device.type != "cpu":
        raise ValueError(f"draw_: no path for device {like.device}")
    if kind not in kernels.DRAW_KINDS:
        raise ValueError(f"kind: one of {sorted(kernels.DRAW_KINDS)}, got "
                         f"{kind!r}")
    if stream not in _HOST_STREAM:
        raise ValueError(f"stream: one of {kernels.DRAW_STREAMS}, got "
                         f"{stream!r}")
    seed, step, _ = _host_scalars(dev, seed, step)
    gen = rng.generator("cpu", seed, _HOST_STREAM[stream], step)
    draw = torch.randn if kind == "normal" else torch.rand
    return draw(like.shape, generator=gen, dtype=torch.float32)


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
