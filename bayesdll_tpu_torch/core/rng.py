"""Counter-derived random generators.

The JAX package derives every key by `fold_in` from one base key.  Here a
`torch.Generator` is seeded from the tuple (seed, stream, *counters) mixed
through splitmix64, so each draw is a pure function of the run's seed and
where it happens (step, component, batch) — runs repeat exactly on the same
device.  The streams differ from JAX's; tests compare distributions, or
hand both sides the same numbers.

Chain c of a multi-chain run (parallel/) draws everything from its own
seed, `chain_seed(seed, c)`, in place of the run's seed: its kernels' noise,
its VI, MC-dropout and Adam draws, its likelihood and eval draws, its
initial jitter and its cold restarts.  A single-chain run keeps the run's
seed.
"""

from __future__ import annotations

import torch

_MASK64 = (1 << 64) - 1

# streams: one per place that draws
EVAL = 1
LIKELIHOOD = 2
TRAIN_CPU = 3
ADAM = 4          # Adam-SGHMC's and Adam-cSGHMC's momentum noise
VI = 5            # VI's reparameterisation draw
MC_DROPOUT = 6    # MC-dropout's keep-mask during training
REINIT = 7        # the fresh θ of a cold restart (per cycle)
CHAIN = 8         # a multi-chain run's per-chain seeds
JITTER = 9        # the jitter of a chain's initial iterate


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def mix(*ints: int) -> int:
    """One 63-bit seed from a tuple of integers."""
    h = 0
    for v in ints:
        h = _splitmix64(h ^ (int(v) & _MASK64))
    return h >> 1


def generator(device, *ints: int) -> torch.Generator:
    """A generator on `device` seeded from the tuple `ints`."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(mix(*ints))
    return g


def chain_seed(seed: int, c: int) -> int:
    """The seed of chain c of a multi-chain run with the run's `seed`."""
    return mix(seed, CHAIN, c)
