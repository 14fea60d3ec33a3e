"""Directory checkpoints through `torch.distributed.checkpoint` (DCP), the
port's counterpart of bayesdll_tpu.utils.checkpoint, which saves through
orbax's `StandardCheckpointer`.

The default runner checkpoints are single-file pickles.  This module saves
a sampler state as a DCP directory instead: the tensors in DCP's shard
files, the state's other values (the host counters: a state's `step` and
Adam's `t`, the moments' `cnt` or `n`) as DCP's pickled objects.

Usage:
    from bayesdll_tpu_torch.utils import checkpoint as ckpt
    ckpt.save(path_dir, runner.state)
    state = ckpt.restore(path_dir, runner.state)  # loads into its tensors

A state is a dataclass, a dict, a list or tuple of them, or a tensor, nested
as the runners nest them.  DCP takes nested dicts with string keys, so a
dataclass goes to it as the dict of its fields and a list as a dict keyed
by position; `restore` rebuilds the template's structure from what DCP
loaded.

Both calls run in one process without a process group (DCP then reads and
writes every tensor itself), or on every rank of one: each rank then saves
and loads the entries of its own tree (entries of one key on several ranks
are one replicated value, which DCP writes once), and rank 0 alone moves
the directories, between barriers.  A failed save or load raises.

A rank that holds a slice of a longer vector (an fsdp shard) puts it in the
tree as `global_slice(local, total, mesh)`: a DTensor over the live tensor,
sharded along its one dimension over `mesh`, which DCP writes and reads at
its global offset.  A key is then the whole vector whatever the layout: a
directory saved by ranks that each held a slice loads into one process's
whole tensor, and a whole tensor's into slices, each rank reading the
bytes of its own slice.  `restore` hands back the local tensor of such an
entry (a view of the live tensor's storage, loaded in place).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import warnings

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor, Shard

# DCP warns on every call made without a process group
_NO_GROUP = "torch.distributed is disabled, unavailable or uninitialized"


def global_slice(local: torch.Tensor, total: int, mesh) -> DTensor:
    """`local`, this rank's slice [r·n, (r+1)·n) of a [total] vector split
    evenly over the ranks of the 1-D DeviceMesh `mesh` (r the rank's place
    in it), as the DTensor of the whole vector that DCP reads and writes at
    the slice's global offset.  It shares `local`'s storage."""
    return DTensor.from_local(local, mesh, [Shard(0)], run_check=False,
                              shape=(int(total),), stride=(1,))


def _to_tree(obj):
    """`obj` as nested dicts with string keys, tensors and other values as
    they are."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _to_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return {str(i): _to_tree(v) for i, v in enumerate(obj)}
    return obj


def _from_tree(template, tree):
    """`template`'s structure with its tensors from `tree` (the template's
    own, loaded in place; a DTensor's local tensor) and its other values
    from `tree`."""
    if isinstance(tree, DTensor):
        return tree.to_local()
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _from_tree(getattr(template, f.name), tree[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _from_tree(v, tree[str(k)]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_from_tree(v, tree[str(i)])
                              for i, v in enumerate(template))
    return tree


def host_values(state) -> dict:
    """The values of `state` that are not tensors (its counters), nested as
    in DCP's tree; subtrees without one are left out."""
    out = {}
    for k, v in _to_tree(state).items():
        if isinstance(v, dict):
            v = host_values(v)
            if v:
                out[k] = v
        elif not isinstance(v, torch.Tensor):
            out[k] = v
    return out


def save(directory: str, state) -> str:
    """Save a sampler state to a DCP checkpoint directory; returns its
    absolute path.  The write goes to a sibling directory that replaces
    `directory` once it is complete, so an earlier checkpoint there is
    replaced whole, and none of its files is left to be read back.  DCP's
    file writer syncs each file it writes (its default), so the data is on
    disk when this returns; the pickle checkpoints are not synced."""
    directory = os.path.abspath(directory)
    tmp = directory + ".tmp"
    ranks = dist.is_initialized() and dist.get_world_size() > 1
    first = not ranks or dist.get_rank() == 0

    def barrier():
        if ranks:
            dist.barrier()
    if first:
        shutil.rmtree(tmp, ignore_errors=True)
    barrier()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_NO_GROUP)
        dcp.save(_to_tree(state), checkpoint_id=tmp)
    barrier()
    if first:
        shutil.rmtree(directory, ignore_errors=True)
        os.replace(tmp, directory)
    barrier()
    return directory


def restore(directory: str, template):
    """Restore a state saved with save().  `template` is the live state (or
    a fresh one of the same structure, shapes and dtypes): its tensors are
    loaded in place, on their own devices, and the result holds them, with
    the saved counters and other values in the template's structure."""
    directory = os.path.abspath(directory)
    tree = _to_tree(template)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=_NO_GROUP)
        dcp.load(tree, checkpoint_id=directory)
    return _from_tree(template, tree)
