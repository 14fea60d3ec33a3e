"""V-MoE (arXiv:2106.05974) in plain float32: reference/arch/vit.py's ViT
with the MLP of every block in `moe_layers` replaced by a routed mixture
of `num_experts` experts, of which this card holds `experts_held` from
`expert_offset`.

Parameters: vit.py's, with `layers/mlp_dense_0` and `mlp_dense_1` stacked
over the dense blocks only, and `moe/router/kernel` [L_moe, d, E] (no
bias), `moe/mlp_0` (kernel [L_moe, held, d, m], bias [L_moe, held, m]) and
`moe/mlp_1` (kernel [L_moe, held, m, d], bias [L_moe, held, d]); each
expert kernel drawn with std sqrt(1 / its own fan_in).

An MoE layer, for the N = B T tokens of the call ((image, token) order)
after `ln_2`: logits x W_r, p = softmax(logits); each token's K chosen
experts and their kept flags are either `routing`'s or, without it, its
own top-K of p and `own_kept` of those; the gates are p at the chosen
experts, computed here from the reference's own logits either way, not
renormalised.  `own_kept` is the capacity rule: each held expert takes
at most round(K N C / E) choices of the group, first choices of all
tokens, then second choices, each in token order, counted expert by
expert; the rest are dropped.  (The `moe_sample` loop hands in the
program's experts with `own_kept` of them over the whole group, since it
runs the group in blocks.)  The output adds, for every kept choice of a
held expert e, g_e(x) (gelu(x W0_e + b0_e) W1_e + b1_e) to the residual.
Experts held elsewhere add nothing.

`record`, where given, receives each MoE layer's own top-K experts [N, K]
(int64, from the reference's logits on the path it runs) and the kept
flags it used, as (experts, kept) pairs.

Departures from the paper, each a setting of the configuration: the
auxiliary importance and load losses are left out of the potential (the
posterior is the likelihood's and the prior's, as for every backbone);
router noise is left out (the configuration's `router_noise_std` 0, as
in the port); the token priority (GShard's) is assumed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import torch
import torch.nn.functional as F

from benchmark.reference.arch import conv, vit
from benchmark.reference.layout import Leaf

LN_EPS = vit.LN_EPS


@dataclasses.dataclass(frozen=True)
class ExpertLeaf(Leaf):
    """A [layers, experts, in, out] kernel: fan_in is `in` alone."""

    def init_std(self) -> float:
        return math.sqrt(1.0 / self.shape[-2])


def leaves(c: dict) -> List[Leaf]:
    d, m = c["hidden_size"], c["intermediate_size"]
    n_moe = len(c["moe_layers"])
    n_dense = c["num_hidden_layers"] - n_moe
    held, e = c["experts_held"], c["num_experts"]
    out = []
    for leaf in vit.leaves(c):
        if leaf.path[1:2] in (("mlp_dense_0",), ("mlp_dense_1",)):
            leaf = dataclasses.replace(leaf, shape=(n_dense,) + leaf.shape[1:])
        out.append(leaf)
    for name, (fi, fo) in (("mlp_0", (d, m)), ("mlp_1", (m, d))):
        out.append(ExpertLeaf(("moe", name, "kernel"), (n_moe, held, fi, fo),
                              "fan_in", True))
        out.append(Leaf(("moe", name, "bias"), (n_moe, held, fo), "const",
                        True))
    out.append(Leaf(("moe", "router", "kernel"), (n_moe, d, e), "fan_in",
                    True))
    return out


def capacity(c: dict, tokens: int) -> int:
    return int(round(c["num_selected_experts"] * tokens
                     * c["capacity_factor"] / c["num_experts"]))


def own_kept(c: dict, experts: torch.Tensor) -> torch.Tensor:
    """[N, K] bool: the choices a held expert takes under the capacity
    rule, counted choice by choice and expert by expert."""
    cap = capacity(c, experts.shape[0])
    kept = torch.zeros_like(experts, dtype=torch.bool)
    lo = c.get("expert_offset", 0)
    for e in range(lo, lo + c["experts_held"]):
        taken = 0
        for k in range(experts.shape[1]):
            rows = torch.nonzero(experts[:, k] == e).flatten()
            room = max(0, min(rows.numel(), cap - taken))
            kept[rows[:room], k] = True
            taken += rows.numel()
    return kept


def moe(c, p, j, y, ops, routing=None, record=None):
    """MoE layer j's residual branch on y [N, d]."""
    logits = ops.mm(y, p[("moe", "router", "kernel")][j])
    probs = torch.softmax(logits, dim=-1)
    own = probs.detach().topk(c["num_selected_experts"], dim=-1).indices
    if routing is None:
        experts, kept = own, own_kept(c, own)
    else:
        experts, kept = routing[j]
    if record is not None:
        record.append((own, kept))
    gates = probs.gather(1, experts)
    out = torch.zeros_like(y)
    lo = c.get("expert_offset", 0)
    for e in range(c["experts_held"]):
        tok, k = torch.nonzero((experts == lo + e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue

        def w(name, part):
            return p[("moe", name, part)][j, e]
        hid = F.gelu(ops.mm(y[tok], w("mlp_0", "kernel")) + w("mlp_0", "bias"))
        val = ops.mm(hid, w("mlp_1", "kernel")) + w("mlp_1", "bias")
        out = out.index_add(0, tok, gates[tok, k, None] * val)
    return out


def forward(p, x, config, ops, stats=None, train=True, routing=None,
            record=None):
    """Logits of NHWC images x; `routing` and `record` as the module
    says, each a list over the MoE layers for this call's tokens."""
    c = config
    d, heads = c["hidden_size"], c["num_attention_heads"]
    hd = d // heads
    b = x.shape[0]
    h = conv(x.permute(0, 3, 1, 2), p[("conv_proj", "kernel")], ops,
             stride=c["patch_size"], bias=p[("conv_proj", "bias")])
    h = h.permute(0, 2, 3, 1).reshape(b, -1, d)
    h = torch.cat([p[("class_token",)].expand(b, -1, -1), h], dim=1) \
        + p[("pos_embedding",)]
    t = h.shape[1]
    moe_layers = list(c["moe_layers"])
    for i in range(c["num_hidden_layers"]):
        def w(*path, at=i):
            return p[("layers",) + path][at]
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
        if i in moe_layers:
            j = moe_layers.index(i)
            h = h + moe(c, p, j, y.reshape(b * t, d), ops, routing,
                        record).view(b, t, d)
        else:
            at = i - sum(1 for m in moe_layers if m < i)
            hid = F.gelu(ops.mm(y, w("mlp_dense_0", "kernel", at=at))
                         + w("mlp_dense_0", "bias", at=at))
            h = h + ops.mm(hid, w("mlp_dense_1", "kernel", at=at)) \
                + w("mlp_dense_1", "bias", at=at)
    y = F.layer_norm(h[:, 0], (d,), p[("ln", "scale")], p[("ln", "bias")],
                     LN_EPS)
    return ops.mm(y, p[("head", "kernel")]) + p[("head", "bias")]
