"""Flat-vector parameter representation (counterpart of bayesdll_tpu.core.flat).

The master copy of the parameters is ONE contiguous fp32 vector; the model
sees views into it.  The layout is exactly the JAX package's
`ravel_pytree` layout: leaves in sorted-key order of the nested parameter
dict (so `head` precedes `layers_0`), each leaf row-major in its own shape
(Dense kernels stay [in, out]).  θ, gradients and masks therefore match the
JAX package element for element.

Every function takes a nested dict whose leaves are tensors or numpy arrays.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, Iterator, Tuple

import numpy as np
import torch


def _leaves_with_path(params, prefix=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(path names, leaf) in ravel_pytree order: dict keys sorted, depth first."""
    if isinstance(params, Mapping):
        for k in sorted(params):
            yield from _leaves_with_path(params[k], prefix + (str(k),))
    else:
        yield prefix, params


def _size(leaf) -> int:
    return int(np.prod(tuple(leaf.shape), dtype=np.int64))


def flatten_params(params) -> Tuple[torch.Tensor, Callable]:
    """Flatten a nested parameter dict to one fp32 vector + an unravel closure."""
    leaves = [(leaf if isinstance(leaf, torch.Tensor)
               else torch.from_numpy(np.array(leaf, np.float32)))
              .reshape(-1).to(torch.float32)
              for _, leaf in _leaves_with_path(params)]
    theta = torch.cat(leaves) if leaves else torch.zeros(0)
    return theta, make_unravel(params)


def path_masks(
    params,
    readout_name: str = "head",
    bias_leaf_names: Tuple[str, ...] = ("bias",),
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-element bool masks (is_head, is_bias) aligned with flatten_params.

    A leaf is head iff `readout_name` appears in any path component, and
    bias iff its last path component is one of `bias_leaf_names`.
    """
    head_chunks, bias_chunks = [], []
    for names, leaf in _leaves_with_path(params):
        n = _size(leaf)
        head_chunks.append(np.full((n,), any(readout_name in s for s in names)))
        bias_chunks.append(np.full((n,), bool(names) and names[-1] in bias_leaf_names))
    if not head_chunks:
        return np.zeros((0,), np.bool_), np.zeros((0,), np.bool_)
    return np.concatenate(head_chunks), np.concatenate(bias_chunks)


def make_unravel(params) -> Callable:
    """Flat vector -> nested dict of VIEWS into it (original leaf shapes).

    One `torch.split` plus a `view` per leaf, the counterpart of the JAX
    package's single `lax.split`.  The views share storage with the vector,
    so autograd through them yields the gradient as one flat tensor.  A
    vector longer than the parameters (padding) has its tail ignored.
    """
    items = list(_leaves_with_path(params))
    shapes = [tuple(leaf.shape) for _, leaf in items]
    sizes = [_size(leaf) for _, leaf in items]
    paths = [names for names, _ in items]
    total = sum(sizes)

    def unravel(v: torch.Tensor):
        pad = v.shape[0] - total
        chunks = torch.split(v, sizes + [pad] if pad else sizes)
        out: dict = {}
        for names, chunk, shape in zip(paths, chunks, shapes):
            node = out
            for name in names[:-1]:
                node = node.setdefault(name, {})
            node[names[-1]] = chunk.view(shape)
        return out

    return unravel


def leaf_spans(params):
    """(names, start, size) per leaf in flatten order."""
    spans = []
    offset = 0
    for names, leaf in _leaves_with_path(params):
        n = _size(leaf)
        spans.append(("/".join(names), offset, n))
        offset += n
    return spans


def dotted(params, prefix: str = "") -> dict:
    """Nested dict -> {"a.b": leaf}: the names `torch.func.functional_call`
    expects for a module whose submodules carry the dict's keys."""
    out = {}
    for k, v in params.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(dotted(v, name + "."))
        else:
            out[name] = v
    return out
