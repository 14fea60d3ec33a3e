"""Sampler updates over the flat parameter vector (counterpart of
bayesdll_tpu.ops.fused).

`sgld_update`, `sghmc_update` and `csghmc_update` are the plain PyTorch
versions, with the JAX package's formulas and contracts; they are the
oracles the tests and chip_smoke.py hold the kernels against.  The
versions with a trailing underscore are what the runners call: on CUDA
tensors they launch the hand-written kernel (ops/kernels.py) and nothing
else; on CPU tensors they run the plain version.  Each takes the seed, the
step and csghmc's gate either as host values (the per-step path) or as
`dev`, an int64 row (seed, step, gate) on the vectors' device (the fused
path, whose captured graph cannot take host values that change from step
to step).  Host values become that row once, through
`kernels.dev_scalars`; the kernel reads it on the card, and the CPU reads
it as the same three values.  `adam_sghmc_update` and its momentum,
`adam_sghmc_momentum`, are the plain versions of Adam-SGHMC's update, in
place on the Adam state; `adam_sghmc_update_` is what the Adam runners
call: the momentum and the torch-SGD step after it, on the card one pass
of the adam_sghmc_update kernel (which the JAX package, leaving the update
to XLA, has no Pallas counterpart of), bit for bit the plain versions'
composition there.  `draw_` is the whole-vector draw of VI and
MC-dropout: the philox_draw kernel on the card, a host generator keyed by
(seed, stream, step) on the CPU; the Adam noise is that draw on its own
stream, which the Adam kernel computes in its pass.  Each of these takes
`elem0` and `total` for a shard of a longer vector (one rank's slice of a
sharded flat state): the kernels draw the noise of global elements
[elem0, elem0 + n) of a vector of `total` elements; the CPU draws the
whole vector's noise from its generator and takes the shard's slice, so
the shards of a sharded run see the replicated run's noise on either
device.  `box_muller_fp32` is the five kernels' Box-Muller
(csrc/normal_from_bits.cuh) step for step in fp32 torch ops: the tests
hold it against float64 over every input, chip_smoke.py holds the card's
normals against it.

SGLD and SGHMC clamp the per-element lr at LR_FLOOR inside the noise scale
and the drift, as the Pallas kernels do (bayesdll_tpu/ops/pallas_kernels.py
`_sgld_kernel`, `_sghmc_kernel`).  That changes nothing where lr >= 1e-30;
where lr = 0 (a run with lr_head 0) the JAX package's default XLA path
gives NaN or inf, and the port stays finite.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.core.moments import div_as_host_scalar
from bayesdll_tpu_torch.core.sgd import sgd_step
from bayesdll_tpu_torch.ops import kernels
from bayesdll_tpu_torch.utils import profiling

LR_FLOOR = 1e-30


def _in_update_span(fn):
    """fn, each call recorded as an `update` span (utils/profiling.py)."""
    @functools.wraps(fn)
    def recorded(*args, **kw):
        with profiling.span("update"):
            return fn(*args, **kw)
    return recorded


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
    where given: the pair as fp32 [2] on the vectors' device (the fused
    path, whose captured step cannot take them from the host), which
    divides with the host floats' bits.  z is `noise` when given, else
    drawn from `generator`; at nd = 0 nothing is drawn.  Plain PyTorch on
    any device: the oracle of the adam_sghmc_update kernel, which on the
    card computes its bits (`adam_sghmc_update_`).  Each of
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


def shard_of_draw(draw, like: torch.Tensor, gen, elem0: int, total):
    """`draw` (torch.randn or torch.rand) from `gen` shaped as `like` (1-D);
    for a shard at elem0 of a vector of `total` elements, the slice
    [elem0, elem0 + n) of the whole vector's draw."""
    n = like.shape[0]
    if total is None:
        return draw(like.shape, generator=gen, dtype=torch.float32)
    if elem0 < 0 or elem0 + n > total:
        raise ValueError(f"shard [{elem0}, {elem0 + n}) is not inside a "
                         f"vector of {total}")
    return draw(int(total), generator=gen, dtype=torch.float32)[
        elem0:elem0 + n]


def _noise(t: torch.Tensor, name: str, seed: int, step: int, elem0: int,
           total):
    """The plain version's noise argument: the generator keyed by (seed,
    step) for a whole vector, or for a shard the whole vector's normals'
    slice (`shard_of_draw`)."""
    gen = _cpu_generator(t, name, seed, step)
    if total is None:
        return {"generator": gen}
    return {"noise": shard_of_draw(torch.randn, t, gen, elem0, total)}


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


# csrc/normal_from_bits.cuh's Box-Muller constants (hex floats, as there):
# -2 log1p(-g/2) = g + g^2 P(g), P highest degree first; cos(pi t/4) = 1 +
# u Q(u) and sin(pi t/4) = t (pi/4 + u S(u)), u = t^2, S's last term pi/4's
# low part
NEG2_LOG1P_P = tuple(float.fromhex(h) for h in (
    "0x1.09a086p-12", "0x1.1f3c64p-11", "0x1.f22e7cp-11", "0x1.1eaa56p-9",
    "0x1.55a8f4p-8", "0x1.99d31p-7", "0x1.fffe7ap-6", "0x1.5555p-4",
    "0x1p-2"))
COS_Q = tuple(float.fromhex(h) for h in (
    "0x1.d9f7cep-19", "-0x1.55c664p-12", "0x1.03c1dep-6", "-0x1.3bd3ccp-2"))
SIN_S = tuple(float.fromhex(h) for h in (
    "-0x1.2d7a96p-15", "0x1.465e32p-9", "-0x1.4abbbap-4", "-0x1.777a5cp-26"))
PI_4 = float.fromhex("0x1.921fb6p-1")  # pi/4's high part
NEG2_LN2 = float.fromhex("-0x1.62e43p+0")  # -2 ln 2 in fp32
V_MIN = float.fromhex("0x1.ad7f2ap+0")  # fp32 1e-7 times 2^24, exactly


def _fma32(a, b, c):
    """fp32 a * b + c rounded once, as __fmaf_rn rounds it (a, b, c fp32
    tensors or floats that are fp32 values): the product is exact in
    float64, the sum is rounded there to odd (its exact error from TwoSum),
    and rounding to odd at 53 bits, then to nearest at 24, rounds
    correctly."""
    like = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (x.double() if isinstance(x, torch.Tensor) else
               torch.tensor(x, dtype=torch.float64, device=like.device)
               for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, math.inf, -math.inf).to(s)
    return torch.where(inexact_even, torch.nextafter(s, toward), s).float()


def neg2_log_u1_fp32(b1):
    """normal_from_bits.cuh::neg2_log_u1 in fp32 torch ops: -2 ln(max(k
    2^-24, 1e-7)), k = b1 >> 8, by the kernel's exponent split and
    polynomial."""
    v = torch.clamp((b1 >> 8).float(), min=V_MIN)
    ix = v.view(torch.int32).long()
    e = (ix - 0x3F2AAAAB) >> 23
    g = _fma32((ix - (e << 23)).int().view(torch.float32), -2.0, 2.0)
    ef = (e - 24).float()  # the kernel's magic-number conversion, exact
    p = torch.full_like(g, NEG2_LOG1P_P[0])
    for c in NEG2_LOG1P_P[1:]:
        p = _fma32(p, g, c)
    return _fma32(ef, NEG2_LN2, _fma32(p, g * g, g))


def sqrt_newton_fp32(a):
    """normal_from_bits.cuh::sqrt_newton, with the correctly rounded fp32
    1/sqrt(a) in place of MUFU.RSQ's approximation (the one step where the
    card's bits may differ by an ulp)."""
    y = torch.rsqrt(a.double()).float()
    r0 = a * y
    return _fma32(_fma32(-r0, r0, a), y * 0.5, r0)


def cos_sin_2pi_fp32(b2):
    """normal_from_bits.cuh::cos_sin_2pi in fp32 torch ops: (cos, sin) of
    2 pi (b2 >> 8) 2^-24, from the nearest quadrant and t in [-1, 1)."""
    w = (b2 + 0x20000000) & _M32
    t = _fma32(((w >> 8) & 0x3FFFFF).float(), 2.0 ** -21, -1.0)
    u = t * t
    q = torch.full_like(u, COS_Q[0])
    for c in COS_Q[1:]:
        q = _fma32(q, u, c)
    cr = _fma32(u, q, 1.0)
    p = torch.full_like(u, SIN_S[0])
    for c in SIN_S[1:-1]:
        p = _fma32(p, u, c)
    p = _fma32(u, p, SIN_S[-1])
    sr = _fma32(t, PI_4, t * p)
    swap = (w >> 30) & 1 == 1
    c = torch.where(swap, sr, cr)
    s = torch.where(swap, cr, sr)
    return (torch.where(((w >> 30) ^ (w >> 31)) & 1 == 1, -c, c),
            torch.where(w >> 31 == 1, -s, s))


def box_muller_fp32(b1, b2):
    """normal_from_bits.cuh::box_muller step for step in fp32 (each
    __fmaf_rn rounded once, as on the card) of two int64 tensors of Philox
    words: (r cos, r sin) of 2 pi u2, r = sqrt(-2 ln u1).  Equal to the
    kernel's normals bit for bit but where MUFU.RSQ's approximation moves r
    by an ulp."""
    r = sqrt_newton_fp32(neg2_log_u1_fp32(b1))
    c, s = cos_sin_2pi_fp32(b2)
    return r * c, r * s


def philox_draw_plain(n: int, *, kind: str, stream: int, seed: int,
                      step: int, device="cpu", offset: int = 0,
                      fp32: bool = False):
    """The plain version of the philox_draw kernel: elements [offset, offset
    + n) (offset a multiple of 4) of its draw at (seed, step, stream), with
    its counter layout, its 24-bit uniforms (bit for bit) and its
    Box-Muller, here in float64 from the same uniforms and rounded to fp32
    (the yardstick the kernel's normals are held to), or with `fp32` the
    kernel's own fp32 arithmetic (`box_muller_fp32`).  Integer tensor ops,
    as slow as they are plain: a yardstick, not a path."""
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
    elif kind == "normal" and fp32:
        out = torch.stack([*box_muller_fp32(*words[:2]),
                           *box_muller_fp32(*words[2:])], 1)
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


def _host_scalars(dev):
    """(seed, step, gate) that the row `dev` holds, read on the CPU, where
    reading waits on nothing."""
    seed, step, gate = (int(x) for x in dev.tolist())
    return seed & kernels._U64, step, bool(gate)


@_in_update_span
def draw_(like, *, kind: str, stream: int, seed: int = 0, step: int = 0,
          dev=None, elem0: int = 0, total=None):
    """A new fp32 vector shaped as `like` (1-D) of N(0, 1) (kind "normal")
    or U[0, 1) (kind "uniform") draws, a pure function of (seed, step,
    stream), `stream` one of kernels.DRAW_STREAMS.  On a CUDA tensor the
    philox_draw kernel, which launches or raises; on a CPU tensor the plain
    version, torch.randn or torch.rand from the generator keyed by (seed,
    the stream's host stream, step).  The two give
    other bits of the same distribution.  `dev` (seed, step, gate), when
    given, stands for seed and step.  With `total`, `like` is the shard at
    elem0 of a vector of `total` elements, and the draw is that slice of
    the whole vector's draw."""
    if dev is None:
        dev = kernels.dev_scalars(seed, step, device=like.device)
    if like.is_cuda:
        return kernels.philox_draw(like, dev, kind=kind, stream=stream,
                                   elem0=elem0)
    return _host_draw(like, kind, stream, dev, elem0, total)


def _host_draw(like, kind: str, stream: int, dev, elem0: int, total):
    """draw_'s plain version, on a CPU tensor `like`."""
    if like.device.type != "cpu":
        raise ValueError(f"draw_: no path for device {like.device}")
    if kind not in kernels.DRAW_KINDS:
        raise ValueError(f"kind: one of {sorted(kernels.DRAW_KINDS)}, got "
                         f"{kind!r}")
    if stream not in _HOST_STREAM:
        raise ValueError(f"stream: one of {kernels.DRAW_STREAMS}, got "
                         f"{stream!r}")
    seed, step, _ = _host_scalars(dev)
    gen = rng.generator("cpu", seed, _HOST_STREAM[stream], step)
    draw = torch.randn if kind == "normal" else torch.rand
    return shard_of_draw(draw, like, gen, elem0, total)


@_in_update_span
def csghmc_update_(g, theta, v, *, prior_sig: float, n_eff: float, nd: float,
                   alpha: float, lr, should_sample: bool = False,
                   seed: int = 0, step: int = 0, dev=None, elem0: int = 0,
                   total=None):
    """csghmc_update IN PLACE on theta and v; the noise is a pure function of
    (seed, step).  CUDA tensors go to the kernel, which launches or raises;
    CPU tensors take the plain version.  `dev` (seed, step, gate), when
    given, stands for seed, step and should_sample; `elem0` and `total`
    place a shard in its whole vector (module docstring)."""
    if dev is None:
        dev = kernels.dev_scalars(seed, step, should_sample, theta.device)
    if theta.is_cuda:
        return kernels.csghmc_update(
            g, theta, v, lr, dev, prior_sig=prior_sig, alpha=alpha,
            noise_pref=kernels.noise_prefactor(nd, alpha, n_eff), elem0=elem0)
    seed, step, should_sample = _host_scalars(dev)
    th_new, v_new = csghmc_update(
        g, theta, v, prior_sig=prior_sig, n_eff=n_eff, nd=nd, alpha=alpha,
        lr=lr, should_sample=should_sample,
        **_noise(theta, "csghmc_update_", seed, step, elem0, total))
    theta.copy_(th_new)
    v.copy_(v_new)
    return theta, v


@_in_update_span
def sgld_update_(g, theta, theta0, prior_mask, lr, *, prior_sig: float,
                 n_eff: float, nd: float, seed: int = 0, step: int = 0,
                 dev=None, elem0: int = 0, total=None):
    """sgld_update IN PLACE on g; the noise is a pure function of (seed,
    step).  CUDA tensors go to the kernel, which launches or raises; CPU
    tensors take the plain version.  `dev`, when given, stands for seed and
    step; `elem0` and `total` place a shard in its whole vector."""
    if dev is None:
        dev = kernels.dev_scalars(seed, step, device=g.device)
    if g.is_cuda:
        return kernels.sgld_update(g, theta, theta0, prior_mask, lr, dev,
                                   prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                                   elem0=elem0)
    seed, step, _ = _host_scalars(dev)
    noise = _noise(g, "sgld_update_", seed, step, elem0, total) \
        if nd != 0.0 else {}
    return g.copy_(sgld_update(g, theta, theta0, prior_mask, lr,
                               prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                               **noise))


@_in_update_span
def sghmc_update_(g, theta, theta0, v, prior_mask, lr, *, prior_sig: float,
                  n_eff: float, nd: float, alpha: float, seed: int = 0,
                  step: int = 0, dev=None, elem0: int = 0, total=None):
    """sghmc_update IN PLACE on g and v, as sgld_update_ dispatches.
    Returns (g, v)."""
    if dev is None:
        dev = kernels.dev_scalars(seed, step, device=g.device)
    if g.is_cuda:
        return kernels.sghmc_update(g, theta, theta0, v, prior_mask, lr, dev,
                                    prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                                    alpha=alpha, elem0=elem0)
    seed, step, _ = _host_scalars(dev)
    noise = _noise(g, "sghmc_update_", seed, step, elem0, total) \
        if nd != 0.0 else {}
    g_new, v_new = sghmc_update(g, theta, theta0, v, prior_mask, lr,
                                prior_sig=prior_sig, n_eff=n_eff, nd=nd,
                                alpha=alpha, **noise)
    g.copy_(g_new)
    v.copy_(v_new)
    return g, v


@_in_update_span
def adam_sghmc_update_(g, theta, theta0, v_mom, m, v2, buf, t: int,
                       prior_mask, lr, *, add_g: bool, momentum: float,
                       sgd_count: int, seed: int = 0, step: int = 0,
                       dev=None, bc=None, elem0: int = 0, total=None, **kw):
    """Adam-SGHMC's momentum and the torch-SGD step after it, IN PLACE on
    v_mom, m, v2, theta and buf: `adam_sghmc_momentum` (its keywords in
    `kw`), then core/sgd.py::sgd_step with momentum `momentum` at the
    runner's step count `sgd_count` on SGD's gradient, g + v_mom'
    (`add_g`, Adam-SGHMC) or v_mom' (Adam-cSGHMC).  CUDA tensors go to the
    adam_sghmc_update kernel, which takes the SGD step in its pass at
    momentum 0 and otherwise leaves the gradient (written over g where
    `add_g`) to the eager step; CPU tensors take the plain versions, the
    noise drawn as `draw_` draws it on STREAM_ADAM.  `dev`, when given,
    stands for seed and step; `bc`, Adam's bias corrections as an fp32 [2]
    on the vectors' device (the fused path's), for the host's
    `adam_bias_corrections(t)`; `elem0` and `total` place a shard in its
    whole vector.  Returns (theta, v_mom, m, v2)."""
    if dev is None:
        dev = kernels.dev_scalars(seed, step, device=g.device)
    if g.is_cuda:
        if bc is None:
            bc = kernels.bias_row(*adam_bias_corrections(
                t, kw["beta1"], kw["beta2"]), device=g.device)
        kernels.adam_sghmc_update(
            g, theta, theta0, v_mom, m, v2, prior_mask, lr, bc, dev,
            add_g=add_g, sgd_step=momentum == 0.0, elem0=elem0, **kw)
        if momentum != 0.0:
            sgd_step(theta, g if add_g else v_mom, buf, lr, momentum,
                     sgd_count)
        return theta, v_mom, m, v2
    noise = _host_draw(g, "normal", kernels.STREAM_ADAM, dev, elem0, total) \
        if kw["nd"] != 0.0 else None
    adam_sghmc_momentum(g, theta, theta0, v_mom, m, v2, t, prior_mask, lr,
                        noise=noise, bc=bc, **kw)
    sgd_grad = v_mom
    if add_g:  # over g where the card's pass leaves it there
        sgd_grad = g.add_(v_mom) if momentum != 0.0 else g + v_mom
    sgd_step(theta, sgd_grad, buf, lr, momentum, sgd_count)
    return theta, v_mom, m, v2
