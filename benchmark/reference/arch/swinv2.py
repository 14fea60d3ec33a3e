"""Swin Transformer V2 (arXiv:2111.09883) in plain float32, after the
paper and the official code's equations (microsoft/Swin-Transformer,
`models/swin_transformer_v2.py`).

Configuration keys: `image_size`, `num_channels`, `patch_size`,
`embed_dim`, `depths`, `num_heads`, `window_size`,
`pretrained_window_sizes`, `mlp_ratio`, `num_classes`.

Parameters: `head` ([C, K] kernel, bias); the final `norm`; `patch_embed`
(`conv`: HWIO kernel [p, p, 3, C] and bias; `norm`); per stage s
`stages_<s>/blocks/...`, every block leaf stacked over the stage's depth:
`attn/qkv/kernel` [L, C, 3C] (no bias), `attn/q/bias` and `attn/v/bias`
[L, C], `attn/logit_scale` [L, heads] (ln 10 at the start), the CPB MLP
`attn/cpb_0` ([L, 2, 512] kernel, bias) and `attn/cpb_1` ([L, 512, heads]
kernel, no bias), `attn/proj`, `mlp_0` [L, C, rC], `mlp_1` [L, rC, C],
`norm1`, `norm2`; and after every stage but the last `stages_<s>/merge`
(`reduction` kernel [4C, 2C], no bias; `norm` [2C]).

Forward: the stride-p patch convolution and a LayerNorm (eps 1e-5 in every
LayerNorm here); stage s at width C 2^s on an R x R token grid with window
M = min(window, R), every odd block shifted by M/2 where R > M; a block is
    x = x + LN1(windows reversed and rolled back of proj(A v))
    x = x + LN2(mlp_1(GELU(mlp_0(x))))        (exact-erf GELU)
with, per window of the rolled grid and head,
    A = softmax(exp(min(logit_scale, ln 100)) q^ k^T + 16 sigmoid(B) + mask),
q^ and k^ the L2-normalised rows of q and k (qkv = x W + [q_bias, 0,
v_bias]), B the CPB MLP over the log-spaced relative coordinates
sign(t) ln(1 + |t|) / ln 8, t = 8 delta / (pretrained window - 1),
indexed by each pair of tokens' offset, and the mask -100 between tokens
that lie in different regions of the rolled grid (the official slices
(0, -M), (-M, -M/2), (-M/2, R) on each axis).  Patch merging concatenates
the 2x2 neighbours in the order (0, 0), (1, 0), (0, 1), (1, 1), reduces
them and normalises.  The head: the final LayerNorm, the mean over tokens,
the linear readout.

So that a batch of 64 at 384 x 384 fits one card, each block runs under
`torch.utils.checkpoint`, and within it the attention in chunks of windows,
each chunk checkpointed too: the backward recomputes what it needs.  That
only recomputes; it changes none of the mathematics.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.arch import conv
from benchmark.reference.layout import Leaf

LN_EPS = 1e-5
CPB_HIDDEN = 512
# at most this many float32 attention scores in one chunk (512 MB)
CHUNK_ELEMENTS = 1 << 27


def stages(c: dict) -> List[dict]:
    """Per stage: width, heads, depth, grid side, window, shift of the odd
    blocks, pretrained window."""
    grid = c["image_size"] // c["patch_size"]
    out = []
    for s, (depth, heads) in enumerate(zip(c["depths"], c["num_heads"])):
        r = grid // 2 ** s
        m = min(c["window_size"], r)
        out.append({"width": c["embed_dim"] * 2 ** s, "heads": heads,
                    "depth": depth, "grid": r, "window": m,
                    "shift": m // 2 if r > m else 0,
                    "pretrained": c["pretrained_window_sizes"][s]})
    return out


def leaves(c: dict) -> List[Leaf]:
    p, ch, k = c["patch_size"], c["num_channels"], c["num_classes"]
    st = stages(c)
    top = st[-1]["width"]
    out = [
        Leaf(("head", "bias"), (k,), "const"),
        Leaf(("head", "kernel"), (top, k), "head"),
        Leaf(("norm", "bias"), (top,), "const"),
        Leaf(("norm", "scale"), (top,), "const", value=1.0),
        Leaf(("patch_embed", "conv", "bias"), (c["embed_dim"],), "const"),
        Leaf(("patch_embed", "conv", "kernel"), (p, p, ch, c["embed_dim"]),
             "fan_in"),
        Leaf(("patch_embed", "norm", "bias"), (c["embed_dim"],), "const"),
        Leaf(("patch_embed", "norm", "scale"), (c["embed_dim"],), "const",
             value=1.0),
    ]
    for s, sd in enumerate(st):
        n, h, w = sd["depth"], sd["heads"], sd["width"]
        hid = c["mlp_ratio"] * w
        blk = (f"stages_{s}", "blocks")
        kernels = {("attn", "qkv"): (w, 3 * w), ("attn", "proj"): (w, w),
                   ("attn", "cpb_0"): (2, CPB_HIDDEN),
                   ("attn", "cpb_1"): (CPB_HIDDEN, h),
                   ("mlp_0",): (w, hid), ("mlp_1",): (hid, w)}
        for sub, shape in kernels.items():
            out.append(Leaf(blk + sub + ("kernel",), (n,) + shape, "fan_in",
                            True))
        for sub, width in ((("attn", "q"), w), (("attn", "v"), w),
                           (("attn", "proj"), w),
                           (("attn", "cpb_0"), CPB_HIDDEN),
                           (("mlp_0",), hid), (("mlp_1",), w)):
            out.append(Leaf(blk + sub + ("bias",), (n, width), "const", True))
        out.append(Leaf(blk + ("attn", "logit_scale"), (n, h), "const", True,
                        math.log(10.0)))
        for norm in ("norm1", "norm2"):
            out.append(Leaf(blk + (norm, "scale"), (n, w), "const", True,
                            1.0))
            out.append(Leaf(blk + (norm, "bias"), (n, w), "const", True))
        if s + 1 < len(st):
            mg = (f"stages_{s}", "merge")
            out += [Leaf(mg + ("reduction", "kernel"), (4 * w, 2 * w),
                         "fan_in"),
                    Leaf(mg + ("norm", "scale"), (2 * w,), "const", value=1.0),
                    Leaf(mg + ("norm", "bias"), (2 * w,), "const")]
    return out


def partition(x, m):
    """[B, R, R, C] -> [B x windows, M^2, C], windows row-major."""
    b, r, _, c = x.shape
    return x.view(b, r // m, m, r // m, m, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(-1, m * m, c)


def reverse(w, b, r, m):
    """partition's inverse."""
    c = w.shape[-1]
    return w.view(b, r // m, r // m, m, m, c).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, r, r, c)


def region_mask(r, m, shift, device):
    """[windows, M^2, M^2]: -100 between tokens of different regions."""
    img = torch.zeros(1, r, r, 1, device=device)
    cnt = 0
    for hs in (slice(0, -m), slice(-m, -shift), slice(-shift, None)):
        for ws in (slice(0, -m), slice(-m, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = partition(img, m).squeeze(-1)
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def position_bias(k0, b0, k1, sd, ops):
    """[heads, N, N]: 16 sigmoid of the CPB MLP's table at each pair's
    offset."""
    m, dev = sd["window"], k0.device
    rel = torch.arange(-(m - 1), m, dtype=torch.float32, device=dev)
    t = torch.stack(torch.meshgrid(rel, rel, indexing="ij"), -1)
    t = t / (sd["pretrained"] - 1) * 8.0
    t = torch.sign(t) * torch.log1p(t.abs()) / math.log(8.0)
    table = ops.mm(torch.relu(ops.mm(t.reshape(-1, 2), k0) + b0), k1)
    coords = torch.stack(torch.meshgrid(torch.arange(m, device=dev),
                                        torch.arange(m, device=dev),
                                        indexing="ij")).flatten(1)
    rel_pos = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) \
        + (m - 1)
    index = rel_pos[..., 0] * (2 * m - 1) + rel_pos[..., 1]
    n = m * m
    return 16.0 * torch.sigmoid(
        table[index.reshape(-1)].view(n, n, -1).permute(2, 0, 1))


def _attend(q, k, v, scale, bias, mask, ops):
    a = scale * ops.mm(q, k.transpose(-2, -1)) + bias
    if mask is not None:
        a = a + mask[:, None]
    return ops.mm(torch.softmax(a, dim=-1), v)


def block(x, wt, sd, shifted, ops):
    b, r, _, c = x.shape
    m, heads = sd["window"], sd["heads"]
    n, d = m * m, c // heads
    s = sd["shift"] if shifted else 0
    y = torch.roll(x, (-s, -s), (1, 2)) if s else x
    win = partition(y, m)
    qkv = ops.mm(win, wt["qkv_kernel"]) + torch.cat(
        [wt["q_bias"], torch.zeros_like(wt["q_bias"]), wt["v_bias"]])
    q, k, v = qkv.view(-1, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
    scale = torch.exp(torch.clamp(wt["logit_scale"], max=math.log(100.0)))
    scale = scale.view(heads, 1, 1)
    bias = position_bias(wt["cpb_0_kernel"], wt["cpb_0_bias"],
                         wt["cpb_1_kernel"], sd, ops)
    mask = region_mask(r, m, s, x.device) if s else None
    nw = (r // m) ** 2
    chunk = max(1, CHUNK_ELEMENTS // (heads * n * n))
    outs = []
    for c0 in range(0, q.shape[0], chunk):
        c1 = min(q.shape[0], c0 + chunk)
        mk = None if mask is None else mask[torch.arange(
            c0, c1, device=x.device) % nw]
        outs.append(checkpoint(_attend, q[c0:c1], k[c0:c1], v[c0:c1], scale,
                               bias, mk, ops, use_reentrant=False))
    o = torch.cat(outs).transpose(1, 2).reshape(-1, n, c)
    o = ops.mm(o, wt["proj_kernel"]) + wt["proj_bias"]
    o = reverse(o, b, r, m)
    if s:
        o = torch.roll(o, (s, s), (1, 2))
    x = x + F.layer_norm(o, (c,), wt["norm1_scale"], wt["norm1_bias"], LN_EPS)
    z = ops.mm(F.gelu(ops.mm(x, wt["mlp_0_kernel"]) + wt["mlp_0_bias"]),
               wt["mlp_1_kernel"]) + wt["mlp_1_bias"]
    return x + F.layer_norm(z, (c,), wt["norm2_scale"], wt["norm2_bias"],
                            LN_EPS)


_BLOCK_LEAVES = {
    "qkv_kernel": ("attn", "qkv", "kernel"), "q_bias": ("attn", "q", "bias"),
    "v_bias": ("attn", "v", "bias"),
    "logit_scale": ("attn", "logit_scale"),
    "cpb_0_kernel": ("attn", "cpb_0", "kernel"),
    "cpb_0_bias": ("attn", "cpb_0", "bias"),
    "cpb_1_kernel": ("attn", "cpb_1", "kernel"),
    "proj_kernel": ("attn", "proj", "kernel"),
    "proj_bias": ("attn", "proj", "bias"),
    "mlp_0_kernel": ("mlp_0", "kernel"), "mlp_0_bias": ("mlp_0", "bias"),
    "mlp_1_kernel": ("mlp_1", "kernel"), "mlp_1_bias": ("mlp_1", "bias"),
    "norm1_scale": ("norm1", "scale"), "norm1_bias": ("norm1", "bias"),
    "norm2_scale": ("norm2", "scale"), "norm2_bias": ("norm2", "bias"),
}


def forward(p, x, config, ops, stats=None, train=True):
    c0 = config["embed_dim"]
    h = conv(x.permute(0, 3, 1, 2), p[("patch_embed", "conv", "kernel")], ops,
             stride=config["patch_size"],
             bias=p[("patch_embed", "conv", "bias")]).permute(0, 2, 3, 1)
    h = F.layer_norm(h, (c0,), p[("patch_embed", "norm", "scale")],
                     p[("patch_embed", "norm", "bias")], LN_EPS)
    st = stages(config)
    for s, sd in enumerate(st):
        blk = (f"stages_{s}", "blocks")
        for i in range(sd["depth"]):
            wt = {k: p[blk + path][i] for k, path in _BLOCK_LEAVES.items()}
            h = checkpoint(block, h, wt, sd, i % 2 == 1, ops,
                           use_reentrant=False)
        if s + 1 < len(st):
            mg = (f"stages_{s}", "merge")
            h = torch.cat([h[:, 0::2, 0::2], h[:, 1::2, 0::2],
                           h[:, 0::2, 1::2], h[:, 1::2, 1::2]], -1)
            h = F.layer_norm(ops.mm(h, p[mg + ("reduction", "kernel")]),
                             (2 * sd["width"],), p[mg + ("norm", "scale")],
                             p[mg + ("norm", "bias")], LN_EPS)
    top = st[-1]["width"]
    h = F.layer_norm(h, (top,), p[("norm", "scale")], p[("norm", "bias")],
                     LN_EPS).mean(dim=(1, 2))
    return ops.mm(h, p[("head", "kernel")]) + p[("head", "bias")]
