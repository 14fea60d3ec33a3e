"""Analytic operation and byte counts of SwinV2 (reference/arch/swinv2.py)
from a configuration's sizes: the forward's multiply-adds, and the
attention cores' work and traffic per image, which the per-layer metrics
hold the measured times against.

Per image, with T = R^2 tokens, width C, window N = M^2 tokens and
heads h of width d at each block of a stage:
  * the forward: the patch convolution R0^2 p^2 3 C0; per block the four
    token-wise products (4 + 2 r) T C^2 (qkv 3, proj 1, the MLP 2 r) and
    the attention cores 2 T N C (q k^T and A v over T / N windows of h
    heads); per merge (T / 4) 4C 2C; the head C K.  The CPB MLP runs once
    a forward whatever the batch and is left out.  2 FLOPs a multiply-add;
    a training step counts 3 x the forward, nothing recomputed.
  * the attention cores of a training step, per window and head:
    12 N^2 d FLOPs (two products forward, four backward) and 24 N d bytes
    (q, k, v, o, dO, dq, dk, dv, and q, k, v read again by the backward,
    each moved once in bf16).  The bias and mask tensors' traffic is left
    out: a kernel is held to the cores' own work.
"""

from __future__ import annotations

from benchmark.reference.arch.swinv2 import stages


def forward_macs(c: dict) -> int:
    st = stages(c)
    grid = c["image_size"] // c["patch_size"]
    macs = grid * grid * c["patch_size"] ** 2 * c["num_channels"] \
        * c["embed_dim"]
    for i, s in enumerate(st):
        t, w, n = s["grid"] ** 2, s["width"], s["window"] ** 2
        macs += s["depth"] * ((4 + 2 * c["mlp_ratio"]) * t * w * w
                              + 2 * t * n * w)
        if i + 1 < len(st):
            macs += (t // 4) * (4 * w) * (2 * w)
    return macs + st[-1]["width"] * c["num_classes"]


def forward_flops(c: dict) -> float:
    """Forward FLOPs of one image (2 a multiply-add)."""
    return 2.0 * forward_macs(c)


def attention_core_macs(c: dict) -> int:
    """The attention cores' multiply-adds of one image's forward."""
    return sum(s["depth"] * 2 * s["grid"] ** 2 * s["window"] ** 2
               * s["width"] for s in stages(c))


def attention_step(c: dict, images: int):
    """(FLOPs, bytes) of the attention cores of a training step over
    `images` images: per window and head 12 N^2 d and 24 N d."""
    flops = nbytes = 0
    for s in stages(c):
        n, d = s["window"] ** 2, s["width"] // s["heads"]
        problems = s["depth"] * (s["grid"] ** 2 // n) * s["heads"]
        flops += problems * 12 * n * n * d
        nbytes += problems * 24 * n * d
    return float(flops * images), float(nbytes * images)


def attention_bound_s(c: dict, images: int, peak_flops: float,
                      bytes_per_s: float) -> float:
    """The cores' roofline time: the larger of compute and traffic."""
    flops, nbytes = attention_step(c, images)
    return max(flops / peak_flops, nbytes / bytes_per_s)
