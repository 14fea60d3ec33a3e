"""Vision Transformer backbones, torchvision-compatible parameters
(counterpart of bayesdll_tpu.models.vit).

The flax encoder is `nn.scan` over one EncoderBlock, so every block leaf is
stacked along a leading depth axis: `layers/attention/qkv/kernel` is one
[depth, dim, 3 dim] leaf.  This module declares the same stacked shapes
under the same names (`layers.attention.qkv.kernel`, ...), so the
sorted-key flat layout (core/flat.py) is the JAX package's element for
element: class_token, conv_proj, head, layers/{attention/{out, qkv}, ln_1,
ln_2, mlp_dense_0, mlp_dense_1}, ln, pos_embedding.  The forward unbinds
each stacked leaf once into per-layer views (its backward is one stack) and
runs the blocks in a Python loop.

Numerics follow the flax module: the NHWC input is cast to `dtype`, the
patch convolution's NHWC output becomes tokens in row-major (h, w) order,
the class token is prepended and `pos_embedding` added; pre-LN blocks with
packed qkv split q, k, v along the last axis; exact-erf GELU unless
`gelu_approx`; the final LayerNorm, token 0, the head, fp32 logits.  With
`fused_attention` the attention core is `F.scaled_dot_product_attention`
(the JAX package's `jax.nn.dot_product_attention`, a library call there
too); without it, the explicit einsum pair with fp32 products and an fp32
softmax.

Remat (`remat=True`) checkpoints each block with torch.utils.checkpoint,
recomputing in the backward pass what the policy does not save:
  ""       saves nothing inside the block: the whole block is recomputed;
  "dots"   saves the outputs of the matrix products and of the attention
           core (JAX's dots_saveable) and recomputes the layer norms, the
           bias adds, GELU and the residual adds;
  "names"  saves exactly what the JAX package marks with checkpoint_name:
           qkv and mlp_hidden (the block's first and third products, which
           widen a token to 3 dim and mlp_dim, or under tensor parallelism
           to the rank's 3 dim / n and mlp_dim / n; their bias is added
           again on recompute) and attn_out (the attention core; in the
           einsum path the product of the probabilities with v, and where
           the token count equals the head width the logits product as
           well).  The out-projection is recomputed, as in JAX.
The last two are selective checkpointing policies over the block's ATen
ops.  None of them changes the numbers.  A tensor-parallel block is
checkpointed as any other: "dots" saves the sums over the model group
(the row-parallel products' outputs), so its recompute runs no
collective; "" and "names" recompute the out-projection, and with it its
sum over the group.  Recomputation stops at the last tensor the backward
needs, before the second sum, so a block's backward runs one collective
more than without remat.

Tensor parallelism (`tp`, parallel/tp.py::make_tp_constraints): each block
runs Megatron-style over the ranks of a 'model' group, as the JAX package's
constrain_inner / constrain_outer hooks have XLA place it: qkv is
column-parallel, split by heads (model rank m holds heads [m·H/n,
(m+1)·H/n) of q, k and v, and their attention), mlp_dense_0 is
column-parallel, out and mlp_dense_1 are row-parallel, their partial
products summed over the group before the bias.  Every rank unravels the
whole θ and slices the leaves it uses; the block's carry [B, T, D] is
whole on every rank.  The attention core is the same call on the rank's
heads.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from bayesdll_tpu_torch.models.layers import (Conv, Dense, LayerNorm, dense,
                                              init_params, layer_norm,
                                              shape_only, to_nchw)

REMAT_POLICIES = ("", "dots", "names")


class LayerWeights(NamedTuple):
    """One block's views into the stacked leaves."""
    ln_1_scale: torch.Tensor
    ln_1_bias: torch.Tensor
    qkv_kernel: torch.Tensor
    qkv_bias: torch.Tensor
    out_kernel: torch.Tensor
    out_bias: torch.Tensor
    ln_2_scale: torch.Tensor
    ln_2_bias: torch.Tensor
    mlp_0_kernel: torch.Tensor
    mlp_0_bias: torch.Tensor
    mlp_1_kernel: torch.Tensor
    mlp_1_bias: torch.Tensor


class MHSA(nn.Module):
    """torchvision's packed-qkv attention projections, stacked over depth."""

    def __init__(self, dim: int, depth: int, dtype: torch.dtype):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim, dtype, depth=depth)
        self.out = Dense(dim, dim, dtype, depth=depth)


class EncoderBlock(nn.Module):
    """The leaves of all `depth` pre-LN blocks, as flax's scanned
    EncoderBlock holds them."""

    def __init__(self, dim: int, mlp_dim: int, depth: int,
                 dtype: torch.dtype):
        super().__init__()
        self.ln_1 = LayerNorm(dim, depth=depth)
        self.attention = MHSA(dim, depth, dtype)
        self.ln_2 = LayerNorm(dim, depth=depth)
        self.mlp_dense_0 = Dense(dim, mlp_dim, dtype, depth=depth)
        self.mlp_dense_1 = Dense(mlp_dim, dim, dtype, depth=depth)

    def per_layer(self):
        """[LayerWeights of block i for i in range(depth)]."""
        a = self.attention
        stacked = (self.ln_1.scale, self.ln_1.bias, a.qkv.kernel, a.qkv.bias,
                   a.out.kernel, a.out.bias, self.ln_2.scale, self.ln_2.bias,
                   self.mlp_dense_0.kernel, self.mlp_dense_0.bias,
                   self.mlp_dense_1.kernel, self.mlp_dense_1.bias)
        return [LayerWeights(*w) for w in zip(*(t.unbind(0) for t in stacked))]


def _ops(*names):
    """The default overloads of the named ATen ops that this build has."""
    return frozenset(getattr(torch.ops.aten, n).default for n in names
                     if hasattr(torch.ops.aten, n))


_MM, _BMM = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
_PRODUCTS = _ops("mm", "bmm", "addmm", "baddbmm")
# every backend of F.scaled_dot_product_attention
_ATTENTION = _ops("_scaled_dot_product_flash_attention",
                  "_scaled_dot_product_efficient_attention",
                  "_scaled_dot_product_cudnn_attention",
                  "_scaled_dot_product_flash_attention_for_cpu")
_SAVE = ckpt.CheckpointPolicy.MUST_SAVE
_RECOMPUTE = ckpt.CheckpointPolicy.PREFER_RECOMPUTE


# the tensor-parallel block's sum over the model group (parallel/tp.py)
_REDUCE = torch.ops._c10d_functional.all_reduce.default


def _save_dots(ctx, op, *args, **kwargs):
    return _SAVE if op in _PRODUCTS or op in _ATTENTION or op is _REDUCE \
        else _RECOMPUTE


def _names_contexts():
    """The selective checkpointing contexts of the "names" policy for one
    block.  The products are told apart by their order in the block (qkv,
    out, mlp_dense_0, mlp_dense_1), which the forward and the recompute
    share; their shapes can coincide (mlp_dim / n = dim)."""
    products = [0, 0]  # seen in the forward, in the recompute

    def policy(ctx, op, *args, **kwargs):
        if op in _ATTENTION:
            return _SAVE  # attn_out
        if op is _MM:
            i = products[ctx.is_recompute]
            products[ctx.is_recompute] += 1
            return _SAVE if i in (0, 2) else _RECOMPUTE  # qkv, hidden
        if op is _BMM and args[0].shape[-1] == args[0].shape[-2]:
            return _SAVE  # attn_out of the einsum path: [T, T] probs @ v
        return _RECOMPUTE
    return ckpt.create_selective_checkpoint_contexts(policy)


class ViT(nn.Module):
    def __init__(self, patch: int = 32, dim: int = 1024, depth: int = 24,
                 heads: int = 16, mlp_dim: int = 4096, image_size: int = 224,
                 num_classes: int = 1000, dtype: str = "float32",
                 remat: bool = False, remat_policy: str = "",
                 fused_attention: bool = True, gelu_approx: bool = False,
                 tp=None):
        super().__init__()
        if remat and remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {remat_policy!r}; "
                             "expected '' (full remat), 'dots', or 'names'")
        dt = getattr(torch, dtype)
        self.dtype = dt
        self.dim, self.heads, self.mlp_dim = dim, heads, mlp_dim
        self.remat, self.remat_policy = remat, remat_policy
        self.fused_attention = fused_attention
        self.gelu = "tanh" if gelu_approx else "none"
        self.tp = tp
        if tp is not None and (heads % tp.size or mlp_dim % tp.size):
            raise ValueError(f"{heads} heads and mlp_dim {mlp_dim} do not "
                             f"split over {tp.size} model ranks")
        self.conv_proj = Conv(3, dim, patch, stride=patch, use_bias=True,
                              dtype=dt)
        self.class_token = shape_only(1, 1, dim)
        self.pos_embedding = shape_only(1, (image_size // patch) ** 2 + 1, dim)
        self.layers = EncoderBlock(dim, mlp_dim, depth, dt)
        self.ln = LayerNorm(dim)
        self.head = Dense(dim, num_classes, dtype=dt)

    def _attend(self, qkv, d=None, h=None):
        """Attention core: [B, T, 3d] packed qkv of h heads (default the
        model's d and heads) -> [B, T, d] in dtype."""
        b, t, _ = qkv.shape
        d, h = d or self.dim, h or self.heads
        q, k, v = (a.view(b, t, h, d // h).transpose(1, 2)
                   for a in qkv.split(d, dim=-1))  # [B, H, T, hd]
        if self.fused_attention:
            y = F.scaled_dot_product_attention(q, k, v)  # scale 1/sqrt(hd)
        else:
            # bf16 products are exact in fp32: upcast, then fp32 sums and
            # softmax, as the einsums with preferred_element_type=fp32
            q, k, v = q.float(), k.float(), v.float()
            att = torch.softmax(q @ k.transpose(-2, -1) / math.sqrt(d // h),
                                dim=-1)
            y = att @ v
        return y.transpose(1, 2).reshape(b, t, d).to(self.dtype)

    def _block(self, x, w: LayerWeights):
        """Pre-LN encoder block."""
        dt = self.dtype
        qkv = dense(layer_norm(x, w.ln_1_scale, w.ln_1_bias), w.qkv_kernel,
                    w.qkv_bias, dt)
        x = x + dense(self._attend(qkv), w.out_kernel, w.out_bias, dt)
        hidden = dense(layer_norm(x, w.ln_2_scale, w.ln_2_bias),
                       w.mlp_0_kernel, w.mlp_0_bias, dt)
        return x + dense(F.gelu(hidden, approximate=self.gelu),
                         w.mlp_1_kernel, w.mlp_1_bias, dt)

    def _block_tp(self, x, w: LayerWeights):
        """The pre-LN block on model rank m of n: its heads' columns of qkv
        and its columns of mlp_dense_0 (after Megatron's f: identity
        forward, sum over the group backward), its rows of out and
        mlp_dense_1 (summed over the group before the bias: Megatron's
        g)."""
        dt, tp = self.dtype, self.tp
        m, n = tp.rank, tp.size
        dl, hl, ml = self.dim // n, self.heads // n, self.mlp_dim // n
        cols = slice(m * dl, (m + 1) * dl)
        qkv_k = w.qkv_kernel.unflatten(1, (3, self.dim))[:, :, cols].flatten(1)
        qkv_b = w.qkv_bias.unflatten(0, (3, self.dim))[:, cols].flatten()
        qkv = dense(tp.copy_in(layer_norm(x, w.ln_1_scale, w.ln_1_bias)),
                    qkv_k, qkv_b, dt)
        part = self._attend(qkv, dl, hl) @ w.out_kernel[cols].to(dt)
        x = x + (tp.reduce_out(part) + w.out_bias.to(dt))
        hid = slice(m * ml, (m + 1) * ml)
        hidden = dense(tp.copy_in(layer_norm(x, w.ln_2_scale, w.ln_2_bias)),
                       w.mlp_0_kernel[:, hid], w.mlp_0_bias[hid], dt)
        part = F.gelu(hidden, approximate=self.gelu).to(dt) \
            @ w.mlp_1_kernel[hid].to(dt)
        return x + (tp.reduce_out(part) + w.mlp_1_bias.to(dt))

    def _run_block(self, x, w: LayerWeights):
        block = self._block if self.tp is None else self._block_tp
        if not self.remat:
            return block(x, w)
        context = {"": None, "names": _names_contexts,
                   "dots": functools.partial(
                       ckpt.create_selective_checkpoint_contexts,
                       _save_dots)}[self.remat_policy]
        kw = {} if context is None else {"context_fn": context}
        # the blocks draw no random numbers, so no RNG state is stashed
        return ckpt.checkpoint(block, x, w, use_reentrant=False,
                               preserve_rng_state=False, **kw)

    def forward(self, x):
        dt = self.dtype
        b = x.shape[0]
        x = self.conv_proj(to_nchw(x).to(dt))  # [B, D, h, w], channels_last
        # NHWC order, as the flax reshape of the conv output
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.dim)
        cls = self.class_token.to(dt).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embedding.to(dt)
        for w in self.layers.per_layer():
            x = self._run_block(x, w)
        # the final LayerNorm acts token by token, so normalising the class
        # token alone gives flax's values for it
        return self.head(self.ln(x[:, 0])).float()

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh weights as flax initialises them: Dense and conv kernels
        lecun_normal (a stacked kernel layer by layer, fan_in its `in`),
        the head he_normal, biases 0, LayerNorm scale 1 and bias 0,
        `class_token` 0 and `pos_embedding` normal with std 0.02."""
        params = init_params(self, generator)
        params["class_token"] = torch.zeros(tuple(self.class_token.shape))
        params["pos_embedding"] = 0.02 * torch.randn(
            tuple(self.pos_embedding.shape), generator=generator)
        return params


# the registered architectures: patch, dim, depth, heads, mlp_dim, image size
ARCHS = {
    "vit_l_32": dict(patch=32, dim=1024, depth=24, heads=16, mlp_dim=4096,
                     image_size=224),
    "vit_b_16": dict(patch=16, dim=768, depth=12, heads=12, mlp_dim=3072,
                     image_size=224),
    # no reference analog: the smallest ViT, for tests and card-vs-CPU runs
    "vit_tiny": dict(patch=8, dim=64, depth=2, heads=4, mlp_dim=128,
                     image_size=32),
}
