"""Posterior target over a flat parameter vector (counterpart of
bayesdll_tpu.core.prior).

`FlatTarget` holds the prior mean θ0, the per-element head and bias masks,
and the module whose forward runs on views into θ.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from bayesdll_tpu_torch.core import flat as flat_util


@dataclasses.dataclass
class FlatTarget:
    """Fields:
      theta0: fp32 prior-mean vector [dim].
      is_head, is_bias: bool masks [dim] (False over the padding).
      module: the backbone; its own parameters are never read.
      unravel: flat vector -> nested dict of views (core/flat.make_unravel).
      nd_size: training-set size ND that scales the prior and the noise.
      n_params: true parameter count; dim is the padded vector length.
    """

    theta0: torch.Tensor
    is_head: torch.Tensor
    is_bias: torch.Tensor
    module: nn.Module
    unravel: Callable
    nd_size: int = 0
    num_classes: int = 10
    n_params: int = 0

    @property
    def dim(self) -> int:
        return int(self.theta0.shape[0])

    @property
    def device(self) -> torch.device:
        return self.theta0.device

    def forward(self, theta: torch.Tensor, net_state, x, train: bool = False):
        """Apply the backbone with parameters taken as views of `theta`.
        Returns (logits, net_state)."""
        params = flat_util.dotted(self.unravel(theta))
        return functional_call(self.module, params, (x,)), net_state

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


def make_flat_target(
    model: nn.Module,
    *,
    nd_size: int,
    num_classes: int,
    rng: torch.Generator,
    theta0_params=None,
    readout_name: str = "head",
    pad_to: int = 1024,
    device="cuda",
) -> tuple:
    """Build (target, theta_init, net_state_init) for a backbone.

    theta_init is the flat vector of fresh weights drawn from `rng` with
    the backbone's own initialisers.  theta0_params=None is a zero prior
    mean.  pad_to zero-pads the vector to the next multiple, as the JAX
    package does; pad elements are inert (the unravel ignores them, masks
    are False and θ0 is 0 there).
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
    )
    theta = torch.from_numpy(pad_vector(theta_init.numpy(), pad_to))
    return target, theta.to(device), {}
