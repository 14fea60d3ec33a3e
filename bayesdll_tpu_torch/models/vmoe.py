"""V-MoE backbones: a ViT whose every other MLP is a routed mixture of
experts (Riquelme et al., "Scaling Vision with Sparse Mixture of
Experts", NeurIPS 2021, arXiv:2106.05974; google-research/vmoe).  The JAX
package has none.

The blocks are models/vit.py's (its attention core `_attend`, patch
embedding, class token, position embedding and helpers); in the blocks
listed in `moe_layers` the MLP after `ln_2` is an MoE layer over
`num_experts` experts, each an MLP of the dense one's shape (dim ->
mlp_dim -> dim, exact-erf GELU unless `gelu_approx`).  For the N = B T
tokens of a forward (one group: the batch on this card, tokens in (image,
token) order) and each token x:
    gates    g = TOP_K(softmax(x W_r)), the K largest probabilities
             kept as they are (not renormalised), the rest 0;
    output   y = sum over the kept choices e of g_e(x) MLP_e(x), added to
             the residual;
    capacity each expert takes at most round(K N C / E) token-choices; a
             choice past its expert's capacity is dropped (the token keeps
             only its residual for it);
    priority every token's first choice before any second choice, each in
             token order (GShard's order).
W_r is [dim, E] with no bias; the product is taken in fp32 (the operands
in the forward's dtype, exact in fp32), and the softmax and top-K too.
The paper's training adds router noise eps ~ N(0, 1 / E^2) to the logits;
this layer has none (a training regulariser, left out as stochastic depth
is for SwinV2).

Expert share.  A card holds `experts_held` experts from `expert_offset`
of every MoE layer: it routes over all E, takes the capacity rule over
the whole group, and computes only its own experts' part (what expert
parallelism over E / experts_held cards leaves on one).  Nothing stands
in for the other cards' experts: their choices add nothing here.

The layer (`_moe`), with static shapes, no host read and no float
atomics:
  moe.route     the router product, softmax, top-K, and each held choice's
                position in its expert (a prefix count over the choices
                in priority order), kept below the capacity;
  moe.dispatch  each kept choice's slot in [experts_held, capacity]
                (expert-major), the token-choice that owns each slot (one
                scatter whose targets are distinct), and one gather of the
                token rows into the [experts_held, capacity, dim] buffer,
                empty slots reading a zero row;
  moe.experts   two batched products (one per projection) with the bias
                and GELU between;
  moe.combine   each token's K slots gathered back (a dropped or foreign
                choice reads a zero row) and summed with its fp32 gates.
Dispatch and combine are autograd Functions whose backward is gathers
too (the slot map one way, the owner map the other), opening spans
`moe.dispatch.bwd` and `moe.combine.bwd` on the autograd thread; the rest
of the backward is plain autograd.  Two runs are bitwise equal.

Leaves (the sorted-key flat layout, core/flat.py): class_token, conv_proj,
head, layers/{attention/{out, qkv}, ln_1, ln_2} stacked over all blocks,
layers/{mlp_dense_0, mlp_dense_1} stacked over the dense blocks, ln,
moe/{mlp_0/{bias [L_moe, held, mlp_dim], kernel [L_moe, held, dim,
mlp_dim]}, mlp_1/{bias [L_moe, held, dim], kernel [L_moe, held, mlp_dim,
dim]}, router/kernel [L_moe, dim, E]}, pos_embedding.  Expert kernels
are drawn lecun normal per expert (fan_in its `in`).

Refused: tensor parallelism (no Megatron split of the experts here), remat,
and torch.func transforms (Laplace's per-example Fisher: one example
routed alone has its own capacity, so it is another function; the
`la` runner refuses the backbone up front, by `per_example_grads`).

A routing log (`routing_log(model)`) keeps, while open, each MoE
layer's chosen experts [N, K] (int64) and kept flags [N, K] (bool, held
and within capacity) on the device, as `RoutingRecord`s; closed, the
layer checks one attribute.

Spans (utils/profiling.py), id the MoE layer's index: `moe.route`,
`moe.dispatch`, `moe.experts`, `moe.combine` in the forward; in the
backward `moe.dispatch.bwd` and `moe.combine.bwd` (no id; on the autograd
thread, so under no `step` span).  Counters by site `moe`, each MoE
layer of a forward: `moe_tokens` (N K token-choices routed) and
`moe_slots` (experts_held x capacity).
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bayesdll_tpu_torch.models.layers import (Dense, LayerNorm, dense,
                                              layer_norm, shape_only, to_nchw,
                                              variance_scaling)
from bayesdll_tpu_torch.models.vit import MHSA, ViT
from bayesdll_tpu_torch.utils import profiling


class RoutingRecord(NamedTuple):
    """One MoE layer's routing in one forward."""
    layer: int                # index among the MoE layers
    experts: torch.Tensor     # [N, K] int64, in choice order
    kept: torch.Tensor        # [N, K] bool: held here and within capacity


@contextlib.contextmanager
def routing_log(model: "VMoE"):
    """Keeps every MoE layer's routing in `model`'s forwards while open:
    yields the list they append to."""
    was, model.routing = model.routing, []
    try:
        yield model.routing
    finally:
        model.routing = was


def capacity(tokens: int, k: int, factor: float, num_experts: int) -> int:
    """Token-choices an expert takes from a group: round(K N C / E)."""
    return int(round(k * tokens * factor / num_experts))


def route(logits: torch.Tensor, k: int, cap: int, offset: int, held: int):
    """(gates [N, K] fp32, experts [N, K], kept [N, K], slot [N, K]) from
    the router's fp32 logits: top-K of the softmax, each held choice's
    position among its expert's choices in priority order (first choices
    of all tokens, then second, in token order), kept below `cap`; a kept
    choice's slot is local expert x cap + position, any other held x cap
    (the spare row).  The positions are a prefix count along each held
    expert's row of [held, K N] hits (a scan along the contiguous axis:
    one along the K N axis of [K N, held] runs 8 threads deep and took
    most of the layer)."""
    gates, experts = torch.softmax(logits, dim=-1).topk(k, dim=-1)
    local = experts - offset
    mine = (local >= 0) & (local < held)
    order = local.t().reshape(-1)                    # priority order
    hits = (torch.arange(held, device=logits.device)[:, None] == order) \
        & mine.t().reshape(1, -1)                    # [held, K N]
    pos = hits.to(torch.int32).cumsum(-1).gather(
        0, order.clamp(0, held - 1)[None]).view(k, -1).t() - 1
    kept = mine & (pos < cap)
    slot = torch.where(kept, local * cap + pos, held * cap)
    return gates, experts, kept, slot


class _Dispatch(torch.autograd.Function):
    """buf[s] = x[owner[s] // K] (0 for an empty slot), [S, d]; its
    backward gathers each token's K slots and adds them: no atomics."""

    @staticmethod
    def forward(ctx, x, owner, slot, k):
        ctx.save_for_backward(slot)
        return F.pad(x, (0, 0, 0, 1)).index_select(0, owner // k)

    @staticmethod
    def backward(ctx, grad):
        slot, = ctx.saved_tensors
        with profiling.span("moe.dispatch.bwd"):
            return (F.pad(grad, (0, 0, 0, 1)).index_select(
                0, slot.flatten()).view(*slot.shape, -1).sum(1),
                None, None, None)


class _Combine(torch.autograd.Function):
    """y[t] = sum_k gates[t, k] out[slot[t, k]] in fp32 (0 for a spare
    slot), in the compute dtype; its backward gathers too: out's gradient
    at slot s is its owner's gate times the owner's dy, the gates' the dot
    of dy with the slot's output."""

    @staticmethod
    def forward(ctx, out, gates, slot, owner):
        n, k = slot.shape
        picked = F.pad(out, (0, 0, 0, 1)).index_select(0, slot.flatten()) \
            .view(n, k, -1)
        ctx.save_for_backward(picked, gates, owner)
        return (picked.float() * gates[..., None]).sum(1).to(out.dtype)

    @staticmethod
    def backward(ctx, dy):
        picked, gates, owner = ctx.saved_tensors
        n, k = gates.shape
        with profiling.span("moe.combine.bwd"):
            dyf = dy.float()
            g_slot = F.pad(gates.flatten(), (0, 1)).index_select(0, owner)
            d_out = (F.pad(dyf, (0, 0, 0, 1)).index_select(0, owner // k)
                     * g_slot[:, None]).to(picked.dtype)
            d_gates = (dyf[:, None] * picked.float()).sum(-1)
        return d_out, d_gates, None, None


class Experts(nn.Module):
    """One projection of every held expert of every MoE layer: kernel
    [layers, held, in, out] and bias [layers, held, out]."""

    def __init__(self, layers: int, held: int, d_in: int, d_out: int):
        super().__init__()
        self.kernel = shape_only(layers, held, d_in, d_out)
        self.bias = shape_only(layers, held, d_out)


class MoELayers(nn.Module):
    def __init__(self, layers: int, dim: int, mlp_dim: int, experts: int,
                 held: int, dtype: torch.dtype):
        super().__init__()
        self.router = Dense(dim, experts, dtype, depth=layers,
                            use_bias=False)
        self.mlp_0 = Experts(layers, held, dim, mlp_dim)
        self.mlp_1 = Experts(layers, held, mlp_dim, dim)


class Blocks(nn.Module):
    """The blocks' leaves: attention and norms over all of them, the dense
    MLP over the dense ones."""

    def __init__(self, dim: int, mlp_dim: int, depth: int, dense_depth: int,
                 dtype: torch.dtype):
        super().__init__()
        self.ln_1 = LayerNorm(dim, depth=depth)
        self.attention = MHSA(dim, depth, dtype)
        self.ln_2 = LayerNorm(dim, depth=depth)
        self.mlp_dense_0 = Dense(dim, mlp_dim, dtype, depth=dense_depth)
        self.mlp_dense_1 = Dense(mlp_dim, dim, dtype, depth=dense_depth)


class VMoE(ViT):
    # one example routed alone is another function (its own capacity)
    per_example_grads = False

    def __init__(self, *, moe_layers, num_experts: int, experts_held: int,
                 expert_offset: int = 0, num_selected_experts: int = 2,
                 capacity_factor: float = 1.05, depth: int = 24, dim: int = 1024, mlp_dim: int = 4096,
                 remat: bool = False, tp=None, **vit):
        if tp is not None:
            raise ValueError(
                "--tensor_parallel is not supported for V-MoE: its experts "
                "have no Megatron split here (expert parallelism holds "
                "experts_held of them a card); run it without "
                "--tensor_parallel")
        if remat:
            raise ValueError("remat is not supported for V-MoE: a block's "
                             "routing would run, log and count twice")
        if not 0 <= expert_offset <= num_experts - experts_held \
                or experts_held < 1:
            raise ValueError(f"experts [{expert_offset}, {expert_offset} + "
                             f"{experts_held}) are not among {num_experts}")
        super().__init__(depth=depth, dim=dim, mlp_dim=mlp_dim, **vit)
        self.moe_layers = tuple(sorted(moe_layers))
        if not set(self.moe_layers) <= set(range(depth)):
            raise ValueError(f"moe_layers {moe_layers} not in 0..{depth - 1}")
        self.num_experts, self.held = num_experts, experts_held
        self.offset, self.k = expert_offset, num_selected_experts
        self.capacity_factor = capacity_factor
        self.routing: Optional[List[RoutingRecord]] = None  # routing_log
        n_moe = len(self.moe_layers)
        self.layers = Blocks(dim, mlp_dim, depth, depth - n_moe, self.dtype)
        self.moe = MoELayers(n_moe, dim, mlp_dim, num_experts, experts_held,
                             self.dtype)

    def _moe(self, y, j: int, w):
        """MoE layer j on the ln_2 output y [B, T, d]: its residual
        branch."""
        b, t, d = y.shape
        n, held, dt = b * t, self.held, self.dtype
        cap = capacity(n, self.k, self.capacity_factor, self.num_experts)
        router, k0, b0, k1, b1 = w
        xt = y.reshape(n, d)
        with profiling.span("moe.route", j):
            logits = xt.float() @ router.float()
            gates, experts, kept, slot = route(logits, self.k, cap,
                                               self.offset, held)
        if self.routing is not None:
            self.routing.append(RoutingRecord(j, experts.detach(),
                                              kept.detach()))
        profiling.count("moe_tokens", n * self.k, "moe")
        profiling.count("moe_slots", held * cap, "moe")
        with profiling.span("moe.dispatch", j):
            # the token-choice t K + k that fills each slot; n K where none
            owner = torch.full((held * cap + 1,), n * self.k,
                               dtype=torch.int64, device=y.device)
            owner.scatter_(0, slot.flatten(),
                           torch.arange(n * self.k, device=y.device))
            owner = owner[:-1]
            buf = _Dispatch.apply(xt, owner, slot, self.k)
        with profiling.span("moe.experts", j):
            hid = torch.bmm(buf.view(held, cap, d), k0.to(dt)) \
                + b0.to(dt)[:, None]
            hid = F.gelu(hid, approximate=self.gelu)
            out = torch.bmm(hid, k1.to(dt)) + b1.to(dt)[:, None]
        with profiling.span("moe.combine", j):
            return _Combine.apply(out.view(held * cap, d), gates, slot,
                                  owner).view(b, t, d)

    def forward(self, x):
        if torch._C._are_functorch_transforms_active():
            raise ValueError(
                "V-MoE does not run under torch.func transforms (vmap, "
                "grad): an example routed alone has its own capacity, so "
                "per-example gradients (Laplace's Fisher) are another "
                "function's")
        dt = self.dtype
        b = x.shape[0]
        x = self.conv_proj(to_nchw(x).to(dt))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.dim)
        cls = self.class_token.to(dt).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)
        L, m = self.layers, self.moe
        attn = zip(L.ln_1.scale, L.ln_1.bias, L.attention.qkv.kernel,
                   L.attention.qkv.bias, L.attention.out.kernel,
                   L.attention.out.bias, L.ln_2.scale, L.ln_2.bias)
        mlps = iter(zip(L.mlp_dense_0.kernel, L.mlp_dense_0.bias,
                        L.mlp_dense_1.kernel, L.mlp_dense_1.bias))
        moes = iter(enumerate(zip(m.router.kernel, m.mlp_0.kernel,
                                  m.mlp_0.bias, m.mlp_1.kernel,
                                  m.mlp_1.bias)))
        for i, (s1, c1, kq, bq, ko, bo, s2, c2) in enumerate(attn):
            qkv = dense(layer_norm(x, s1, c1), kq, bq, dt)
            x = x + dense(self._attend(qkv), ko, bo, dt)
            y = layer_norm(x, s2, c2)
            if i in self.moe_layers:
                j, w = next(moes)
                x = x + self._moe(y, j, w)
            else:
                k0, b0, k1, b1 = next(mlps)
                x = x + dense(F.gelu(dense(y, k0, b0, dt),
                                     approximate=self.gelu), k1, b1, dt)
        return self.head(self.ln(x[:, 0])).float()

    def init_params(self, generator: torch.Generator) -> dict:
        """The ViT's initialisers, and each expert's kernels lecun normal
        with its own fan_in (dim, mlp_dim), biases 0."""
        params = super().init_params(generator)
        experts = {}
        for name in ("mlp_0", "mlp_1"):
            e = getattr(self.moe, name)
            lead, shape = tuple(e.kernel.shape[:2]), tuple(e.kernel.shape[2:])
            kernel = torch.stack([variance_scaling(shape, 1.0, generator)
                                  for _ in range(lead[0] * lead[1])])
            experts[name] = {"kernel": kernel.view(*lead, *shape),
                             "bias": torch.zeros(tuple(e.bias.shape))}
        params["moe"].update(experts)
        return params


# the registered architectures: the ViT's sizes and the MoE layers'
ARCHS = {
    # V-MoE-L/16, Every-2, E = 32, K = 2 (3.4B parameters whole); a card
    # holds 8 of each layer's 32 experts (4-card expert parallelism)
    "vmoe_l_16": dict(patch=16, dim=1024, depth=24, heads=16, mlp_dim=4096,
                      image_size=224, moe_layers=tuple(range(1, 24, 2)),
                      num_experts=32, experts_held=8,
                      num_selected_experts=2, capacity_factor=1.05),
    # no published analog: the smallest, for tests and card-vs-CPU runs
    "vmoe_tiny": dict(patch=8, dim=64, depth=4, heads=4, mlp_dim=128,
                      image_size=32, moe_layers=(1, 3), num_experts=8,
                      experts_held=4, num_selected_experts=2,
                      capacity_factor=1.05),
}
