"""The flat parameter vector of a configuration, worked out from the
architecture's published description alone.

The program keeps every parameter of a backbone in one fp32 vector.  Its
layout is that of a nested parameter dict flattened depth first with the
keys sorted at every level, each leaf row-major in its own shape, the
whole zero-padded to a multiple of 1024.  This module rebuilds that layout
from a configuration file's sizes, so that the reference reads the vector
with its own views and nothing of the program.  The leaves of each
architecture are its module's (arch/<architecture>.py).

Each leaf also carries how the benchmark draws its initial value (`init`)
and how the comparisons split it: a leaf stacked over depth is compared
layer by layer (`groups`).  Kernels are normal with std sqrt(1/fan_in),
the readout's sqrt(2/fan_in), the position embedding's 0.02; biases and
shifts are 0 and norm scales 1 unless the leaf says otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference import arch

PAD_TO = 1024


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]
    shape: Tuple[int, ...]
    init: str        # "fan_in", "head", "pos", or "const" (= value)
    stacked: bool = False  # a leading layer axis
    value: float = 0.0

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def name(self) -> str:
        return "/".join(self.path)

    def init_std(self) -> float:
        """The std of the leaf's initial draw: lecun normal (1 / fan_in)
        for kernels, he normal (2 / fan_in) for the readout, 0.02 for the
        position embedding, 0 for the constant leaves.  fan_in is the
        product of all but the last axis, the layer axis left out."""
        if self.init in ("fan_in", "head"):
            dims = self.shape[1:-1] if self.stacked else self.shape[:-1]
            scale = 2.0 if self.init == "head" else 1.0
            return math.sqrt(scale / math.prod(dims))
        return 0.02 if self.init == "pos" else 0.0

    def init_mean(self) -> float:
        return self.value if self.init == "const" else 0.0


class Layout:
    """The leaves of a configuration in the vector's order, with offsets."""

    def __init__(self, config: dict):
        leaves = arch.module(config).leaves(config)
        self.leaves = sorted(leaves, key=lambda leaf: leaf.path)
        self.offsets = []
        off = 0
        for leaf in self.leaves:
            self.offsets.append(off)
            off += leaf.size
        self.n_params = off
        self.dim = -(-off // PAD_TO) * PAD_TO

    def unravel(self, flat: torch.Tensor) -> Dict[Tuple[str, ...], torch.Tensor]:
        """{path: view of `flat` in the leaf's shape}."""
        return {leaf.path: flat[o:o + leaf.size].view(leaf.shape)
                for leaf, o in zip(self.leaves, self.offsets)}

    def is_head(self, device) -> torch.Tensor:
        """Bool [dim]: the readout's elements."""
        mask = torch.zeros(self.dim, dtype=torch.bool, device=device)
        for leaf, o in zip(self.leaves, self.offsets):
            if "head" in leaf.path:
                mask[o:o + leaf.size] = True
        return mask

    def groups(self) -> List[Tuple[str, int, int]]:
        """(name, start, size) of the parts the comparisons judge one by
        one: every leaf, a stacked leaf layer by layer."""
        out = []
        for leaf, o in zip(self.leaves, self.offsets):
            if leaf.stacked:
                per = leaf.size // leaf.shape[0]
                out += [(f"{leaf.name}[{i}]", o + i * per, per)
                        for i in range(leaf.shape[0])]
            else:
                out.append((leaf.name, o, leaf.size))
        return out

    def init_vectors(self, device):
        """(mean, std) [dim] of the initial draw, element by element (0
        over the padding): two calls that repeat each leaf's values."""
        sizes = torch.tensor([leaf.size for leaf in self.leaves]
                             + [self.dim - self.n_params], device=device)
        mean = torch.tensor([leaf.init_mean() for leaf in self.leaves] + [0.0],
                            device=device)
        std = torch.tensor([leaf.init_std() for leaf in self.leaves] + [0.0],
                           device=device)
        return (torch.repeat_interleave(mean, sizes, output_size=self.dim),
                torch.repeat_interleave(std, sizes, output_size=self.dim))
