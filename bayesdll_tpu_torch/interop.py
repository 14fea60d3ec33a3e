"""Carry weights across from the JAX package, as numpy arrays only.

The parity tests hand the JAX package's parameters (a nested dict, turned
into numpy by the caller), its flat vectors and its `batch_stats` to the
port through these two functions, so the port itself never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from bayesdll_tpu_torch.core import flat as flat_util
from bayesdll_tpu_torch.core.prior import FlatTarget, auto_fwd_cast, tree_to


def flat_from_param_dict(params, pad_to: int = 1) -> torch.Tensor:
    """θ in ravel_pytree order from a nested dict of numpy arrays, fp32 on
    the CPU, zero-padded to a multiple of pad_to."""
    theta, _ = flat_util.flatten_params(params)
    pad = (-int(theta.shape[0])) % max(int(pad_to), 1)
    return torch.cat([theta, torch.zeros(pad)]) if pad else theta


def target_from_arrays(theta, theta0, is_head, is_bias, *, model,
                       nd_size: int, num_classes: int, batch_stats=None,
                       device="cuda"):
    """(target, theta_init, net_state) from the JAX package's flat arrays
    (padded or not).  `model` is the port's backbone of the same
    architecture: its parameter shapes give the unravel.  `batch_stats`,
    the JAX package's collection of that name as nested numpy arrays,
    becomes net_state["batch_stats"] and marks the target as one with
    batch statistics.  The cast of θ is `auto_fwd_cast`'s, as in
    core/prior.make_flat_target."""
    nested: dict = {}
    for name, p in model.named_parameters():
        *outer, leaf = name.split(".")
        node = nested
        for part in outer:
            node = node.setdefault(part, {})
        node[leaf] = p

    def dev(a, dtype):
        return torch.from_numpy(np.array(a)).to(device, dtype)

    target = FlatTarget(
        theta0=dev(theta0, torch.float32),
        is_head=dev(is_head, torch.bool),
        is_bias=dev(is_bias, torch.bool),
        module=model,
        unravel=flat_util.make_unravel(nested),
        nd_size=nd_size,
        num_classes=num_classes,
        n_params=sum(p.numel() for p in model.parameters()),
        has_batch_stats=batch_stats is not None,
        fwd_cast=auto_fwd_cast(model),
    )
    net_state = {} if batch_stats is None else {
        "batch_stats": tree_to(batch_stats, device)}
    return target, dev(theta, torch.float32), net_state
