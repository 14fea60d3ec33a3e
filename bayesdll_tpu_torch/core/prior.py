"""Posterior target over a flat parameter vector (counterpart of
bayesdll_tpu.core.prior).

`FlatTarget` holds the prior mean θ0, the per-element head and bias masks,
and the module whose forward runs on views into θ.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from bayesdll_tpu_torch.core import flat as flat_util
from bayesdll_tpu_torch.utils import profiling


@dataclasses.dataclass
class FlatTarget:
    """Fields:
      theta0: fp32 prior-mean vector [dim].
      is_head, is_bias: bool masks [dim] (False over the padding).
      module: the backbone; its own parameters are never read.
      unravel: flat vector -> nested dict of views (core/flat.make_unravel).
      nd_size: training-set size ND that scales the prior and the noise.
      n_params: true parameter count; dim is the padded vector length.
      has_batch_stats: the module's forward takes and returns the
        `batch_stats` collection of net_state (BatchNorm running averages).
      fwd_cast: "" or a torch dtype name ("bfloat16"): the forward casts θ
        to it once, at the unravel (`leaves`), in place of a cast of each
        weight at each use inside the model (`auto_fwd_cast` sets it).  For
        the MLP that is the same rounding of the same values, so its numbers
        do not change; the ViT's LayerNorm leaves, which the model would
        use in fp32, are rounded too, as in the JAX package's whole-vector
        cast.  The gradient comes back to the fp32 θ through the cast.
    """

    theta0: torch.Tensor
    is_head: torch.Tensor
    is_bias: torch.Tensor
    module: nn.Module
    unravel: Callable
    nd_size: int = 0
    num_classes: int = 10
    n_params: int = 0
    has_batch_stats: bool = False
    fwd_cast: str = ""

    @property
    def dim(self) -> int:
        return int(self.theta0.shape[0])

    @property
    def device(self) -> torch.device:
        return self.theta0.device

    def leaves(self, theta: torch.Tensor) -> dict:
        """The backbone's parameters, {"a.b": leaf}, as views of `theta`; with
        fwd_cast, each leaf cast once into its own allocation.  The JAX
        package casts the whole vector in one op and unravels views of the
        result; here a view would start at θ's offset, which for most class
        counts leaves every leaf after the head 2 or 4 bytes off the 16-byte
        alignment that Hopper's matrix-product kernels need, and cuBLAS
        then falls back to kernels of an older architecture (PERF.md gives
        the ViT-L/32 step both ways on an H100).  One cast per leaf writes
        the same values to aligned memory: 20 casts for a ViT, whose
        encoder leaves are stacked, against one per use of each weight
        inside the model."""
        params = flat_util.dotted(self.unravel(theta))
        if not self.fwd_cast:
            return params
        dt = getattr(torch, self.fwd_cast)
        with profiling.span("forward.cast"):
            return {name: leaf.to(dt) for name, leaf in params.items()}

    def forward(self, theta: torch.Tensor, net_state, x, train: bool = False):
        """Apply the backbone with parameters taken from `theta` (`leaves`).
        Returns (logits, net_state'), as the JAX package's apply_fn does: in
        train mode a model with batch stats returns its updated
        `batch_stats`; otherwise net_state comes back as it was given."""
        with profiling.span("forward"):
            params = self.leaves(theta)
            if not self.has_batch_stats:
                return functional_call(self.module, params, (x,)), net_state
            logits, stats = functional_call(
                self.module, params, (x, net_state["batch_stats"], train))
        if train:
            return logits, {**net_state, "batch_stats": stats}
        return logits, net_state

    def prior_mask(self, bias_mode: str) -> torch.Tensor:
        """Per-element multiplier for the prior term: bias elements drop out
        under the 'uninformative' / 'ignore' bias modes."""
        if bias_mode in ("uninformative", "ignore"):
            return 1.0 - self.is_bias.to(torch.float32)
        return torch.ones(self.is_bias.shape, dtype=torch.float32,
                          device=self.device)

    def lr_vec(self, lr_body: float, lr_head: float) -> torch.Tensor:
        """Per-element learning rate: lr_head on head elements, else lr_body."""
        return torch.where(
            self.is_head,
            torch.tensor(lr_head, dtype=torch.float32, device=self.device),
            torch.tensor(lr_body, dtype=torch.float32, device=self.device))


def pad_vector(vec: np.ndarray, pad_to: int) -> np.ndarray:
    """Zero-pad a 1-D array to the next multiple of pad_to."""
    pad = (-int(vec.shape[0])) % max(int(pad_to), 1)
    return np.concatenate([vec, np.zeros(pad, vec.dtype)]) if pad else vec


def auto_fwd_cast(model: nn.Module) -> str:
    """The whole-vector cast of a backbone: its dtype when that is not fp32,
    unless the backbone declares `prefer_half_flat = False` (the ResNet: its
    layers cast each leaf)."""
    dt = getattr(model, "dtype", torch.float32)
    enabled = getattr(model, "prefer_half_flat", True)
    return str(dt).removeprefix("torch.") if enabled and dt != torch.float32 \
        else ""


def make_flat_target(
    model: nn.Module,
    *,
    nd_size: int,
    num_classes: int,
    rng: torch.Generator,
    theta0_params=None,
    readout_name: str = "head",
    has_batch_stats: bool = False,
    pad_to: int = 1024,
    device="cuda",
) -> tuple:
    """Build (target, theta_init, net_state_init) for a backbone.

    theta_init is the flat vector of fresh weights drawn from `rng` with
    the backbone's own initialisers.  theta0_params=None is a zero prior
    mean.  pad_to zero-pads the vector to the next multiple, as the JAX
    package does; pad elements are inert (the unravel ignores them, masks
    are False and θ0 is 0 there).  With has_batch_stats, net_state_init is
    {"batch_stats": ...} nested as flax's collection (leaves `mean` and
    `var`); else {}.

    The forward dtype is the backbone's own (`create_backbone(...,
    dtype=)`); `auto_fwd_cast` resolves the whole-vector cast from it, as
    the JAX package does.
    """
    params = model.init_params(rng)
    theta_init, unravel = flat_util.flatten_params(params)
    is_head, is_bias = flat_util.path_masks(params, readout_name=readout_name)
    n_params = int(theta_init.shape[0])
    theta0 = (np.zeros(n_params, np.float32) if theta0_params is None
              else flat_util.flatten_params(theta0_params)[0].numpy())
    target = FlatTarget(
        theta0=torch.from_numpy(pad_vector(theta0, pad_to)).to(device),
        is_head=torch.from_numpy(pad_vector(is_head, pad_to)).to(device),
        is_bias=torch.from_numpy(pad_vector(is_bias, pad_to)).to(device),
        module=model,
        unravel=unravel,
        nd_size=nd_size,
        num_classes=num_classes,
        n_params=n_params,
        has_batch_stats=has_batch_stats,
        fwd_cast=auto_fwd_cast(model),
    )
    theta = torch.from_numpy(pad_vector(theta_init.numpy(), pad_to))
    net_state = {}
    if has_batch_stats:
        net_state = {"batch_stats": tree_to(model.init_batch_stats(), device)}
    return target, theta.to(device), net_state


def tree_to(tree, device, dtype=torch.float32):
    """A nested dict of tensors or arrays as tensors on `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        tree = torch.from_numpy(np.array(tree))
    return tree.to(device, dtype)
