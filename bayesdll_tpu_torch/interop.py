"""Carry weights across from the JAX package, as numpy arrays only.

The parity tests hand the JAX package's parameters (a nested dict, turned
into numpy by the caller), its flat vectors, its `batch_stats` and a
multi-chain trainer's stacked chain states (whole, or as one rank of a
mesh holds them) to the port through these functions, so the port itself
never imports JAX.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from bayesdll_tpu_torch.core import flat as flat_util
from bayesdll_tpu_torch.core.prior import FlatTarget, auto_fwd_cast, tree_to
from bayesdll_tpu_torch.methods import base


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


def _chain_slice(tree, c: int):
    """Row c of every leaf of a stacked state (dataclasses and mappings of
    arrays), as a nested dict of numpy copies."""
    if dataclasses.is_dataclass(tree):
        return {f.name: _chain_slice(getattr(tree, f.name), c)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, Mapping):
        return {k: _chain_slice(v, c) for k, v in tree.items()}
    return np.array(np.asarray(tree)[c])


def chain_states(runner, states, net_states, n_chain: int, device="cuda"):
    """(states, net_states), lists of `n_chain`, for the port's
    MultiChainTrainer from the JAX trainer's stacked ones: `states` a state
    whose leaves are [C, ...] arrays (field names as the port's), and
    `net_states` a nested mapping of [C, ...] arrays.  `runner.state` gives
    the structure."""
    return ([base.from_host(runner.state, _chain_slice(states, c), device)
             for c in range(n_chain)],
            [tree_to(_chain_slice(net_states, c), device)
             for c in range(n_chain)])


def rank_chain_states(trainer, states, net_states, device="cuda"):
    """(states, net_states) for a port MultiChainTrainer over a mesh from
    the JAX trainer's stacked ones ([C, ...] leaves, as `chain_states`
    takes them): the trainer's own chains (`trainer.chains`, by global
    index), each as the rank holds it (its fsdp shard, else whole)."""
    runner = trainer.runner
    return ([trainer.local_state(base.from_host(
        runner.state, _chain_slice(states, c), device))
        for c in trainer.chains],
        [tree_to(_chain_slice(net_states, c), device)
         for c in trainer.chains])
