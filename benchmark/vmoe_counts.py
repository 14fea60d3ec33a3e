"""Analytic operation and byte counts of V-MoE (reference/arch/vmoe.py)
from a configuration's sizes, which the per-layer metrics hold the
measured times against.  2 FLOPs a multiply-add; a training step counts 3
x the forward, nothing recomputed.

Per image, with T = (image / patch)^2 + 1 tokens, width d, MLP width m,
L blocks of which L_moe are MoE layers, E experts of which H are held:
  * the forward: the patch convolution (T - 1) p^2 3 d; per block the
    attention projections 4 T d^2 and its cores 2 T^2 d; per dense block
    the MLP 2 T d m; per MoE layer the router T d E and the held experts'
    products at their capacity's slots, H cap 2 d m over the B images of
    the group (cap = round(K B T C / E), whether a slot is filled or
    not: the products run on every slot); the head d K.
  * the held experts' products of one forward and MoE layer (what the
    `moe.experts` spans launch): 2 H cap 2 d m FLOPs, and bytes each
    operand read once and each result written once in the compute dtype
    (2 bytes): the dispatched rows H cap d, both kernels 2 H d m, the
    hidden H cap m written and read, the output H cap d.
"""

from __future__ import annotations


def tokens(c: dict) -> int:
    return (c["image_size"] // c["patch_size"]) ** 2 + 1


def capacity(c: dict, images: int) -> int:
    return int(round(c["num_selected_experts"] * images * tokens(c)
                     * c["capacity_factor"] / c["num_experts"]))


def experts_forward(c: dict, images: int):
    """(FLOPs, bytes) of the held experts' products of one forward of a
    group of `images`, over every MoE layer."""
    d, m, h = c["hidden_size"], c["intermediate_size"], c["experts_held"]
    cap = capacity(c, images)
    layers = len(c["moe_layers"])
    flops = layers * 2 * h * cap * 2 * d * m
    nbytes = layers * 2 * (h * cap * d + 2 * h * d * m + 2 * h * cap * m
                           + h * cap * d)
    return float(flops), float(nbytes)


def forward_flops(c: dict) -> float:
    """Forward FLOPs of one image of a group of the configuration's
    batch."""
    d, m, L = c["hidden_size"], c["intermediate_size"], c["num_hidden_layers"]
    t, p = tokens(c), c["patch_size"]
    n_moe = len(c["moe_layers"])
    macs = (t - 1) * p * p * c["num_channels"] * d
    macs += L * (4 * t * d * d + 2 * t * t * d)
    macs += (L - n_moe) * 2 * t * d * m
    macs += n_moe * t * d * c["num_experts"]
    macs += d * c["num_classes"]
    experts, _ = experts_forward(c, c["batch_size"])
    return 2.0 * macs + experts / c["batch_size"]


def experts_bound_s(c: dict, forwards: int, peak_flops: float,
                    bytes_per_s: float) -> float:
    """The held experts' products' roofline time over `forwards` forwards
    of the configuration's batch: the larger of compute and traffic."""
    flops, nbytes = experts_forward(c, c["batch_size"])
    return forwards * max(flops / peak_flops, nbytes / bytes_per_s)
