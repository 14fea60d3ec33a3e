"""Swin Transformer V2 backbones (Liu et al., "Swin Transformer V2: Scaling
Up Capacity and Resolution", CVPR 2022, arXiv:2111.09883), with the layer
equations of the official code (microsoft/Swin-Transformer,
`models/swin_transformer_v2.py`) where the paper is silent.

The layer tree, and so the sorted-key flat layout (core/flat.py):
  head (kernel [C4, K], bias), norm (the final LayerNorm),
  patch_embed/{conv (a patch x patch stride-patch convolution 3 -> C1, HWIO
    kernel, bias), norm},
  stages_<s>/blocks/... every block leaf stacked over the stage's depth:
    attn/{cpb_0 (2 -> 512, bias), cpb_1 (512 -> heads, no bias),
          logit_scale [depth, heads], proj (bias), q/bias, qkv (no bias),
          v/bias},
    mlp_0 (C -> r C, bias), mlp_1 (r C -> C, bias), norm1, norm2,
  stages_<s>/merge/{norm, reduction (4 C -> 2 C, no bias)} after every stage
    but the last.
So `path_masks` marks `head`, and as biases the q and v biases, proj's,
the MLP's, the LayerNorms' shifts and the CPB MLP's first layer's.

Numerics.  Tokens are [B, H, W, C] in `dtype`; LayerNorm eps 1e-5 (flax's
1e-6 is the ViT's); exact-erf GELU unless `gelu_approx`.  Stage s has
width C_s = embed 2^s, heads C_s / head width, grid R_s; its window is
M_s = min(window, R_s), and every second block is shifted by M_s / 2 where
R_s > M_s.  A block is res-post-norm:
    x = x + LN1(reverse(attention(partition(roll(x, -shift)))))
    x = x + LN2(MLP(x)),
attention per window and head softmax(tau q^ k^T + 16 sigmoid(CPB) +
mask) v, with q^, k^ L2-normalised (eps 1e-12), tau = exp(min(logit_scale,
ln 100)), the mask -100 between tokens of different shifted regions, and
qkv = x W + [q_bias, 0, v_bias].  The continuous position bias is a 2-layer
MLP (2 -> 512, ReLU, 512 -> heads) over log-spaced relative coordinates,
t = 8 delta / (pretrained window - 1), sign(t) log2(1 + |t|) / log2(8),
gathered into [heads, N, N] by the relative-position index; it is
computed in fp32 from the leaves once a block and a forward.  Patch
merging (V2) concatenates the 2x2 neighbours (x[0::2, 0::2], x[1::2,
0::2], x[0::2, 1::2], x[1::2, 1::2]), reduces 4 C -> 2 C and normalises
after.  The head: the final LayerNorm, the mean over tokens, a Dense.

The attention core is ops/window_attention.py::window_attention on tau
q^ and k^ ([B, windows, heads, N, d], strided views of qkv's output), the
CPB bias [heads, N, N] in fp32 and, in a shifted block, each window's
region labels [windows, N] (int32), from which the core adds the -100
mask itself.  On a card that is hand-written CUDA kernels
(csrc/window_attention.cu): the bias is read in the compute dtype, as
SDPA read it before, and the mask is added in the tile, in fp32; the
backward sums the bias's gradient over the batch and the windows in fp32
inside the kernel.  On the CPU it is the
same formula in plain fp32 torch ops.  The kernels write o laid out [B,
windows, N, heads, d], which the output projection reads as it is.
`fused_attention=False` is refused.

The relative-position index, the coordinate table and the shift masks are
constants of the shapes, built once per device and kept out of the flat
vector.  Remat (`remat=True`, policy "") checkpoints each block.

Spans (utils/profiling.py): `swin.stage` (id the stage) around each
stage, and inside it `swin.window` (roll, partition, reverse), `swin.bias`
(the CPB MLP, its gather, 16 sigmoid), `swin.attn` (the core) and
`swin.merge`.  Counters, a forward: `attn_windows` (windows of the batch
x heads, by site `shifted`, `plain` or `global`: one window covers the
grid) and `attn_mask_bytes` (the bytes of the fp32 bias and of the region
labels handed to the core).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from bayesdll_tpu_torch.models.layers import (Conv, Dense, LayerNorm, dense,
                                              init_params, layer_norm,
                                              shape_only, to_nchw)
from bayesdll_tpu_torch.ops.window_attention import (region_mask,
                                                     window_attention)
from bayesdll_tpu_torch.utils import profiling

LN_EPS = 1e-5
CPB_HIDDEN = 512
LOGIT_SCALE_INIT = math.log(10.0)
LOGIT_SCALE_MAX = math.log(100.0)


class StageShape(NamedTuple):
    """A stage's attention geometry."""
    grid: int      # R: tokens per side
    window: int    # M
    shift: int     # M / 2 on the odd blocks, 0 where one window covers R
    heads: int
    pretrained_window: int


def coords_table(window: int, pretrained_window: int) -> torch.Tensor:
    """[(2M-1)^2, 2] fp32: the log-spaced relative coordinates of every
    offset (dh, dw) in [-(M-1), M-1]^2, row-major."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)
    t = t * 8.0 / (pretrained_window - 1)
    t = torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8.0)
    return t.reshape(-1, 2)


def relative_index(window: int) -> torch.Tensor:
    """[N, N] int64, N = M^2: the row of coords_table of the offset from
    token j to token i of a window (tokens row-major)."""
    ij = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                    indexing="ij")).flatten(1)  # [2, N]
    rel = ij[:, :, None] - ij[:, None, :] + (window - 1)        # [2, N, N]
    return rel[0] * (2 * window - 1) + rel[1]


def region_labels(grid: int, window: int, shift: int) -> torch.Tensor:
    """[R, R] int64: the region of each token of the rolled grid, the
    official slices (0, -M), (-M, -s), (-s, R) on each axis."""
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    labels = torch.zeros(grid, grid, dtype=torch.int64)
    n = 0
    for hs in cuts:
        for ws in cuts:
            labels[hs, ws] = n
            n += 1
    return labels


def window_regions(grid: int, window: int, shift: int) -> torch.Tensor:
    """[windows, N] int32: each window's tokens' regions, row-major."""
    lab = region_labels(grid, window, shift)
    g = grid // window
    return lab.view(g, window, g, window).transpose(1, 2).reshape(
        g * g, -1).to(torch.int32)


def shift_mask(grid: int, window: int, shift: int) -> torch.Tensor:
    """[windows, N, N] fp32: 0 between tokens of one region, -100 else."""
    return region_mask(window_regions(grid, window, shift))


class BlockWeights(NamedTuple):
    """One block's views into its stage's stacked leaves."""
    qkv_kernel: torch.Tensor
    q_bias: torch.Tensor
    v_bias: torch.Tensor
    logit_scale: torch.Tensor
    cpb_0_kernel: torch.Tensor
    cpb_0_bias: torch.Tensor
    cpb_1_kernel: torch.Tensor
    proj_kernel: torch.Tensor
    proj_bias: torch.Tensor
    norm1_scale: torch.Tensor
    norm1_bias: torch.Tensor
    mlp_0_kernel: torch.Tensor
    mlp_0_bias: torch.Tensor
    mlp_1_kernel: torch.Tensor
    mlp_1_bias: torch.Tensor
    norm2_scale: torch.Tensor
    norm2_bias: torch.Tensor


class BiasOnly(nn.Module):
    """A bias leaf of its own (`q/bias`, `v/bias`)."""

    def __init__(self, features: int, depth: int):
        super().__init__()
        self.bias = shape_only(depth, features)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, depth: int, dtype):
        super().__init__()
        self.qkv = Dense(dim, 3 * dim, dtype, depth=depth, use_bias=False)
        self.q = BiasOnly(dim, depth)
        self.v = BiasOnly(dim, depth)
        self.logit_scale = shape_only(depth, heads)
        self.cpb_0 = Dense(2, CPB_HIDDEN, torch.float32, depth=depth)
        self.cpb_1 = Dense(CPB_HIDDEN, heads, torch.float32, depth=depth,
                           use_bias=False)
        self.proj = Dense(dim, dim, dtype, depth=depth)


class Blocks(nn.Module):
    """The leaves of a stage's `depth` blocks, stacked."""

    def __init__(self, dim: int, heads: int, mlp_dim: int, depth: int,
                 dtype):
        super().__init__()
        self.attn = WindowAttention(dim, heads, depth, dtype)
        self.norm1 = LayerNorm(dim, LN_EPS, depth=depth)
        self.mlp_0 = Dense(dim, mlp_dim, dtype, depth=depth)
        self.mlp_1 = Dense(mlp_dim, dim, dtype, depth=depth)
        self.norm2 = LayerNorm(dim, LN_EPS, depth=depth)

    def per_layer(self):
        a = self.attn
        stacked = (a.qkv.kernel, a.q.bias, a.v.bias, a.logit_scale,
                   a.cpb_0.kernel, a.cpb_0.bias, a.cpb_1.kernel,
                   a.proj.kernel, a.proj.bias, self.norm1.scale,
                   self.norm1.bias, self.mlp_0.kernel, self.mlp_0.bias,
                   self.mlp_1.kernel, self.mlp_1.bias, self.norm2.scale,
                   self.norm2.bias)
        return [BlockWeights(*w) for w in zip(*(t.unbind(0) for t in stacked))]


def merge_neighbours(x: torch.Tensor) -> torch.Tensor:
    """[B, R, R, C] -> [B, R/2, R/2, 4C]: each 2x2 patch's tokens
    (0, 0), (1, 0), (0, 1), (1, 1) side by side."""
    return torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                      x[:, 1::2, 1::2]], -1)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype):
        super().__init__()
        self.reduction = Dense(4 * dim, 2 * dim, dtype, use_bias=False)
        self.norm = LayerNorm(2 * dim, LN_EPS)

    def forward(self, x):
        """[B, R, R, C] -> [B, R/2, R/2, 2C]."""
        return self.norm(self.reduction(merge_neighbours(x)))


class Stage(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, depth: int,
                 merge: bool, dtype):
        super().__init__()
        self.blocks = Blocks(dim, heads, mlp_dim, depth, dtype)
        self.merge = PatchMerging(dim, dtype) if merge else None


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int, dtype):
        super().__init__()
        self.conv = Conv(3, dim, patch, stride=patch, use_bias=True,
                         dtype=dtype)
        self.norm = LayerNorm(dim, LN_EPS)


class SwinV2(nn.Module):
    def __init__(self, image_size: int = 384, patch: int = 4,
                 embed_dim: int = 192, depths=(2, 2, 18, 2),
                 heads=(6, 12, 24, 48), window: int = 24,
                 pretrained_windows=(12, 12, 12, 6), mlp_ratio: int = 4,
                 num_classes: int = 1000, dtype: str = "float32",
                 remat: bool = False, remat_policy: str = "",
                 fused_attention: bool = True, gelu_approx: bool = False):
        super().__init__()
        if remat and remat_policy:
            raise ValueError(f"SwinV2 checkpoints whole blocks: remat_policy "
                             f"{remat_policy!r} is not supported (use '')")
        if not fused_attention:
            raise ValueError("SwinV2's attention runs through its window-"
                             "attention core only: fused_attention=False "
                             "is not supported")
        dt = getattr(torch, dtype)
        self.dtype = dt
        self.remat = remat
        self.gelu = "tanh" if gelu_approx else "none"
        grid = image_size // patch
        self.shapes = []
        for s, (depth, h) in enumerate(zip(depths, heads)):
            r = grid >> s
            m = min(window, r)
            self.shapes.append(StageShape(r, m, m // 2 if r > m else 0, h,
                                          pretrained_windows[s]))
        self.patch_embed = PatchEmbed(patch, embed_dim, dt)
        for s, depth in enumerate(depths):
            c = embed_dim << s
            self.add_module(f"stages_{s}", Stage(
                c, heads[s], mlp_ratio * c, depth, s + 1 < len(depths), dt))
        width = embed_dim << (len(depths) - 1)
        self.norm = LayerNorm(width, LN_EPS)
        self.head = Dense(width, num_classes, dtype=dt)
        self._consts = {}

    @property
    def stages(self):
        return [getattr(self, f"stages_{s}") for s in range(len(self.shapes))]

    def constants(self, s: int, device) -> dict:
        """Stage s's coordinate table, relative-position index and the
        shifted windows' region labels (None where no block shifts) on
        `device`, built once."""
        key = (s, str(device))
        if key not in self._consts:
            sh = self.shapes[s]
            self._consts[key] = {
                "table": coords_table(sh.window, sh.pretrained_window)
                .to(device),
                "index": relative_index(sh.window).reshape(-1).to(device),
                "regions": window_regions(sh.grid, sh.window, sh.shift)
                .to(device) if sh.shift else None}
        return self._consts[key]

    def _bias(self, w: BlockWeights, sh: StageShape, const: dict):
        """The attention bias [heads, N, N] in fp32."""
        n = sh.window ** 2
        hid = F.relu(const["table"] @ w.cpb_0_kernel.float()
                     + w.cpb_0_bias.float())
        tbl = hid @ w.cpb_1_kernel.float()                   # [(2M-1)^2, h]
        # gathered head-major: the core reads rows of stride 1
        return 16.0 * torch.sigmoid(
            tbl.t()[:, const["index"]].view(sh.heads, n, n))

    def _attention(self, x, w: BlockWeights, sh: StageShape, const: dict,
                   shifted: bool):
        """x [B, R, R, C] -> the attention branch's output [B, R, R, C]
        before LN1."""
        dt = self.dtype
        b, r, _, c = x.shape
        m, h = sh.window, sh.heads
        g, n, d = r // m, m * m, c // h
        nw = g * g
        shift = sh.shift if shifted else 0
        with profiling.span("swin.window"):
            if shift:
                x = torch.roll(x, (-shift, -shift), (1, 2))
            x = x.view(b, g, m, g, m, c).transpose(2, 3).reshape(b, nw, n, c)
        qkv_bias = torch.cat([w.q_bias, torch.zeros_like(w.q_bias), w.v_bias])
        qkv = dense(x, w.qkv_kernel, qkv_bias, dt).view(b, nw, n, 3, h, d)
        q, k, v = qkv.unbind(3)                      # [B, windows, N, h, d]
        tau = torch.exp(torch.clamp(w.logit_scale.float(),
                                    max=LOGIT_SCALE_MAX)).view(h, 1)
        q = q * (tau / _norm(q)).to(dt)
        k = k * (1.0 / _norm(k)).to(dt)
        with profiling.span("swin.bias"):
            bias = self._bias(w, sh, const)
        regions = const["regions"] if shift else None
        if profiling.recording():
            site = "global" if nw == 1 else "shifted" if shift else "plain"
            profiling.count("attn_windows", b * nw * h, site)
            profiling.count("attn_mask_bytes",
                            bias.numel() * bias.element_size()
                            + (0 if regions is None else
                               regions.numel() * regions.element_size()),
                            site)
        with profiling.span("swin.attn"):
            o = window_attention(q.transpose(2, 3), k.transpose(2, 3),
                                 v.transpose(2, 3), bias, regions)
        o = o.transpose(2, 3).reshape(b, nw, n, c)
        o = dense(o, w.proj_kernel, w.proj_bias, dt)
        with profiling.span("swin.window"):
            o = o.view(b, g, g, m, m, c).transpose(2, 3).reshape(b, r, r, c)
            if shift:
                o = torch.roll(o, (shift, shift), (1, 2))
        return o

    def _block(self, x, w: BlockWeights, sh: StageShape, const: dict,
               shifted: bool):
        dt = self.dtype
        x = x + layer_norm(self._attention(x, w, sh, const, shifted),
                           w.norm1_scale, w.norm1_bias, LN_EPS)
        hidden = F.gelu(dense(x, w.mlp_0_kernel, w.mlp_0_bias, dt),
                        approximate=self.gelu)
        return x + layer_norm(dense(hidden, w.mlp_1_kernel, w.mlp_1_bias, dt),
                              w.norm2_scale, w.norm2_bias, LN_EPS)

    def _run_block(self, x, w, sh, const, shifted):
        if not self.remat:
            return self._block(x, w, sh, const, shifted)
        return ckpt.checkpoint(self._block, x, w, sh, const, shifted,
                               use_reentrant=False, preserve_rng_state=False)

    def forward(self, x):
        dt = self.dtype
        x = self.patch_embed.conv(to_nchw(x).to(dt))  # channels_last
        x = self.patch_embed.norm(x.permute(0, 2, 3, 1))  # [B, R, R, C]
        for s, (stage, sh) in enumerate(zip(self.stages, self.shapes)):
            with profiling.span("swin.stage", id=s):
                const = self.constants(s, x.device)
                for j, w in enumerate(stage.blocks.per_layer()):
                    x = self._run_block(x, w, sh, const, j % 2 == 1)
                if stage.merge is not None:
                    with profiling.span("swin.merge"):
                        x = stage.merge(x)
        x = self.norm(x).mean(dim=(1, 2))
        return self.head(x).float()

    def init_params(self, generator: torch.Generator) -> dict:
        """Fresh weights: Dense and conv kernels lecun_normal (a stacked
        kernel layer by layer), the head he_normal, biases (q and v too)
        0, LayerNorm scales 1, `logit_scale` ln 10."""
        params = init_params(self, generator)
        for s, stage in enumerate(self.stages):
            attn = params[f"stages_{s}"]["blocks"]["attn"]
            shape = tuple(stage.blocks.attn.q.bias.shape)
            attn["q"] = {"bias": torch.zeros(shape)}
            attn["v"] = {"bias": torch.zeros(shape)}
            attn["logit_scale"] = torch.full(
                tuple(stage.blocks.attn.logit_scale.shape), LOGIT_SCALE_INIT)
        return params


def _norm(t: torch.Tensor) -> torch.Tensor:
    """fp32 L2 norm over the last axis, floored at 1e-12 (F.normalize)."""
    return torch.linalg.vector_norm(t, dim=-1, keepdim=True,
                                    dtype=torch.float32).clamp_min(1e-12)


# the registered architectures
ARCHS = {
    # swinv2_large_patch4_window12to24_192to384_22kto1k_ft
    "swinv2_l_w24_384": dict(image_size=384, patch=4, embed_dim=192,
                             depths=(2, 2, 18, 2), heads=(6, 12, 24, 48),
                             window=24, pretrained_windows=(12, 12, 12, 6),
                             mlp_ratio=4),
    # a CPU preset with every kind of stage: shifted windows (16^2 grid,
    # window 8), global (8^2, window 8), clipped global (4^2, window 4)
    "swinv2_tiny": dict(image_size=64, patch=4, embed_dim=32,
                        depths=(2, 2, 2), heads=(2, 4, 8), window=8,
                        pretrained_windows=(4, 4, 2), mlp_ratio=4),
}
