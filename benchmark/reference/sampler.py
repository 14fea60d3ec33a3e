"""The cSGHMC step, its noise, its schedule and its Welford moments, in
plain float32 PyTorch.

Per step, with lr the per-element step size (the body's, or the head's on
the readout), N the training-set size times Ninflate, and z standard
normal noise:

    v     <- (1 - alpha) v - lr (g + prior_sig theta)
             + gate nd sqrt(2 alpha) / N sqrt(lr) z
    theta <- theta + v

gate is 1 on the steps that collect a sample: in the sampling phase of the
cyclical schedule, every `thin`-th step of an epoch.  Those steps then add
theta to the Welford moments (mean, M2; variance M2 / (n - 1)).

The noise is a pure function of (seed, step, element).  On a card it is a
Philox4x32-10 stream (Salmon et al., SC'11) keyed by the run's 64-bit seed,
the counter (element quad, step's low word, stream 0, step's high word),
each word's top 24 bits a uniform and each pair of uniforms two normals by
Box-Muller (u1 clamped at 1e-7), taken here in float64.  On the CPU it is
`torch.randn` from a generator seeded with splitmix64 of (seed, 3, step).
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
CPU_STREAM = 3


def splitmix_seed(*ints: int) -> int:
    """One 63-bit seed from a tuple of integers: splitmix64 chained over
    them, the top 63 bits."""
    h = 0
    for v in ints:
        x = (h ^ (int(v) & _M64))
        x = (x + 0x9E3779B97F4A7C15) & _M64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
        h = x ^ (x >> 31)
    return h >> 1


def generator(device, *ints: int) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(splitmix_seed(*ints))
    return g


def _mulhilo(a: int, b: torch.Tensor):
    """High and low 32-bit words of a * b (b int64 holding 32-bit values),
    by 16-bit halves so that nothing passes 2^63."""
    lo_part = a * (b & 0xFFFF)
    mid = a * (b >> 16) + (lo_part >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (lo_part & 0xFFFF)


def philox_words(quads: torch.Tensor, step: int, stream: int, seed: int):
    """The four 32-bit words of Philox4x32-10 for counter (quad, step low,
    stream, step high) under the key (seed low, seed high)."""
    seed, step = int(seed) & _M64, int(step) & _M64
    x = quads
    y, z, w = (torch.full_like(quads, c)
               for c in (step & _M32, stream, step >> 32))
    k0, k1 = seed & _M32, seed >> 32
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], x)
        hi1, lo1 = _mulhilo(PHILOX_M[1], z)
        x, y, z, w = hi1 ^ y ^ k0, lo1, hi0 ^ w ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & _M32
        k1 = (k1 + PHILOX_W[1]) & _M32
    return x, y, z, w


def philox_normals(n: int, *, seed: int, step: int, device, stream: int = 0,
                   block: int = 1 << 24) -> torch.Tensor:
    """n float32 normals of the card's noise, in blocks of quads."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    quads = (n + 3) // 4
    for q0 in range(0, quads, block):
        q = torch.arange(q0, min(quads, q0 + block), dtype=torch.int64,
                         device=device)
        words = philox_words(q, step, stream, seed)
        u = [(wd >> 8).double() * 2.0 ** -24 for wd in words]
        z = []
        for u1, u2 in ((u[0], u[1]), (u[2], u[3])):
            r = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-7)))
            ang = 2.0 * math.pi * u2
            z += [r * torch.cos(ang), r * torch.sin(ang)]
        vals = torch.stack(z, 1).reshape(-1).float()
        lo = 4 * q0
        out[lo:lo + min(vals.numel(), n - lo)] = vals[:n - lo]
    return out


def normals(n: int, *, seed: int, step: int, device) -> torch.Tensor:
    """The program's noise of one step on `device`."""
    if torch.device(device).type == "cuda":
        return philox_normals(n, seed=seed, step=step, device=device)
    return torch.randn(n, generator=generator("cpu", seed, CPU_STREAM, step),
                       dtype=torch.float32)


class Schedule:
    """The cyclical schedule of K = epochs x batches per epoch steps in M
    cycles: lr = base (1 + cos(pi pos)) / 2, pos the step's place in its
    cycle; the sampling phase where (step M mod K) / K reaches the
    exploration proportion."""

    def __init__(self, base_lr, num_cycles, epochs, batches_per_epoch,
                 proportion_exploration, thin):
        self.base_lr, self.m = base_lr, num_cycles
        self.k = epochs * batches_per_epoch
        self.bpe, self.thin = batches_per_epoch, thin
        self.cycle = max(1, self.k // num_cycles)
        self.threshold = next((r for r in range(self.k + 1)
                               if r / self.k >= proportion_exploration),
                              self.k)

    def lr(self, step: int) -> float:
        pos = (step % self.cycle) / self.cycle
        return float(self.base_lr * (1.0 + np.cos(np.pi * pos)) / 2.0)

    def gate(self, step: int) -> bool:
        return (step * self.m) % self.k >= self.threshold \
            and (step % self.bpe) % self.thin == 0


def lr_vector(lr_t: float, lr_head_ratio: float, is_head: torch.Tensor):
    """The per-element step size: lr_t in float32 on the body, times the
    head's ratio on the readout."""
    body = np.float32(lr_t)
    head = body * np.float32(lr_head_ratio)
    return torch.where(is_head, float(head), float(body))


def csghmc_step(theta, v, g, lr, *, prior_sig, alpha, nd, n_eff, z):
    """One update in place on theta and v; z None on a step without
    noise."""
    v.mul_(1.0 - alpha).sub_(lr * (g + prior_sig * theta))
    if z is not None:
        v.add_(nd * math.sqrt(2.0 * alpha) / n_eff * torch.sqrt(lr) * z)
    theta.add_(v)


class Welford:
    def __init__(self, like):
        self.mean = torch.zeros_like(like)
        self.m2 = torch.zeros_like(like)
        self.n = 0

    def update(self, theta):
        delta = theta - self.mean
        self.mean.add_(delta / (self.n + 1))
        self.m2.add_(delta * (theta - self.mean))
        self.n += 1

    def var(self):
        return torch.clamp(self.m2 / max(self.n - 1.0, 1.0), min=1e-12)
