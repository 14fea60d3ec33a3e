"""ViT (arXiv:2010.11929) in plain float32.

Parameters: `class_token` [1, 1, d], `conv_proj` (HWIO kernel [p, p, 3,
d], bias), `head` ([d, K] kernel, bias), `layers` (every block leaf
stacked over depth: attention `qkv` [L, d, 3d] and `out` [L, d, d],
`ln_1`, `ln_2`, `mlp_dense_0` [L, d, m], `mlp_dense_1` [L, m, d]), the
final `ln`, `pos_embedding` [1, T + 1, d].

Forward: patches by a stride-p convolution, tokens in row-major (h, w)
order, the class token first and the position embedding added; pre-LN
encoder blocks (LayerNorm eps 1e-6, packed qkv split into q, k, v,
softmax(q k^T / sqrt(head width)) v, exact-erf GELU in the MLP); the final
LayerNorm of the class token and the linear head.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from benchmark.reference.arch import conv
from benchmark.reference.layout import Leaf

LN_EPS = 1e-6


def leaves(c: dict) -> List[Leaf]:
    d, L, m = c["hidden_size"], c["num_hidden_layers"], c["intermediate_size"]
    p, k = c["patch_size"], c["num_classes"]
    tokens = (c["image_size"] // p) ** 2 + 1
    ch = c["num_channels"]
    out = [
        Leaf(("class_token",), (1, 1, d), "const"),
        Leaf(("conv_proj", "bias"), (d,), "const"),
        Leaf(("conv_proj", "kernel"), (p, p, ch, d), "fan_in"),
        Leaf(("head", "bias"), (k,), "const"),
        Leaf(("head", "kernel"), (d, k), "head"),
        Leaf(("ln", "bias"), (d,), "const"),
        Leaf(("ln", "scale"), (d,), "const", value=1.0),
        Leaf(("pos_embedding",), (1, tokens, d), "pos"),
    ]
    dense = {("attention", "qkv"): (d, 3 * d), ("attention", "out"): (d, d),
             ("mlp_dense_0",): (d, m), ("mlp_dense_1",): (m, d)}
    for sub, (fi, fo) in dense.items():
        path = ("layers",) + sub
        out.append(Leaf(path + ("kernel",), (L, fi, fo), "fan_in", True))
        out.append(Leaf(path + ("bias",), (L, fo), "const", True))
    for ln in ("ln_1", "ln_2"):
        out.append(Leaf(("layers", ln, "scale"), (L, d), "const", True, 1.0))
        out.append(Leaf(("layers", ln, "bias"), (L, d), "const", True))
    return out


def forward(p, x, config, ops, stats=None, train=True):
    d, heads = config["hidden_size"], config["num_attention_heads"]
    hd = d // heads
    b = x.shape[0]
    h = conv(x.permute(0, 3, 1, 2), p[("conv_proj", "kernel")], ops,
             stride=config["patch_size"], bias=p[("conv_proj", "bias")])
    h = h.permute(0, 2, 3, 1).reshape(b, -1, d)
    h = torch.cat([p[("class_token",)].expand(b, -1, -1), h], dim=1) \
        + p[("pos_embedding",)]
    t = h.shape[1]
    blocks = ("layers",)
    for i in range(config["num_hidden_layers"]):
        def w(*path):
            return p[blocks + path][i]
        y = F.layer_norm(h, (d,), w("ln_1", "scale"), w("ln_1", "bias"),
                         LN_EPS)
        qkv = ops.mm(y, w("attention", "qkv", "kernel")) \
            + w("attention", "qkv", "bias")
        qh, kh, vh = (a.reshape(b, t, heads, hd).transpose(1, 2)
                      for a in qkv.split(d, dim=-1))
        att = torch.softmax(ops.mm(qh, kh.transpose(-2, -1)) / math.sqrt(hd),
                            dim=-1)
        o = ops.mm(att, vh).transpose(1, 2).reshape(b, t, d)
        h = h + ops.mm(o, w("attention", "out", "kernel")) \
            + w("attention", "out", "bias")
        y = F.layer_norm(h, (d,), w("ln_2", "scale"), w("ln_2", "bias"),
                         LN_EPS)
        hid = F.gelu(ops.mm(y, w("mlp_dense_0", "kernel"))
                     + w("mlp_dense_0", "bias"))
        h = h + ops.mm(hid, w("mlp_dense_1", "kernel")) \
            + w("mlp_dense_1", "bias")
    y = F.layer_norm(h[:, 0], (d,), p[("ln", "scale")], p[("ln", "bias")],
                     LN_EPS)
    return ops.mm(y, p[("head", "kernel")]) + p[("head", "bias")]
