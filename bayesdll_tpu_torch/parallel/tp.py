"""Tensor-parallel (Megatron-style) ViT over a ('data', 'model') mesh
(counterpart of bayesdll_tpu.parallel.tp).

* The model: `make_tp_constraints(mesh)` gives the ViT its 'model' group
  (models/vit.py::ViT(tp=...)): column-parallel qkv (by heads) and
  mlp_dense_0, row-parallel out and mlp_dense_1, with Megatron's two
  functions: f, identity forward and a sum over the group backward, before
  each column-parallel product; g, a sum over the group forward and the
  identity backward, after each row-parallel one.  The JAX package gets
  the same placement from XLA through its activation constraints.  Remat
  is not applied to a tensor-parallel block.
* The sampler: the flat state is sliced evenly over every rank of the
  mesh, as the JAX package shards it with P(('data', 'model')): each rank
  keeps D / (n_data·n_model) elements of every vector and runs the update
  kernels on them at their global offset.  The forward all-gathers θ; each
  rank's gradient (its slices of the wide weights, the whole of the other
  leaves, from its slice of the batch) is assembled into the whole batch's
  gradient (parallel/shard.py::FlatShard with the wide-element mask) and
  the rank takes its slice.
* The batch [B, ...] is split over the 'data' ranks; the model ranks of a
  data rank see the same slice.  The step's loss and error are averaged
  (summed) over the data ranks.
* Evaluation, the cycle ends and checkpoints run on the whole state, each
  rank gathering it (`_WHOLE`), every rank through the same tensor-parallel
  forward; what they change in the state is written back to the slices.
  Only rank 0 writes artifacts (the caller clears the others' workdir).

Single chain only: a chain per TP group is a multi-host layout, as in the
JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from bayesdll_tpu_torch.core import flat as flat_util
from bayesdll_tpu_torch.parallel.mesh import _device_type, world_size
from bayesdll_tpu_torch.parallel.shard import FlatShard, RunnerShard

# the ViT leaves sliced over the model ranks (models/vit.py::_block_tp)
WIDE_LEAVES = ("layers/attention/qkv/kernel", "layers/attention/qkv/bias",
               "layers/attention/out/kernel", "layers/mlp_dense_0/kernel",
               "layers/mlp_dense_0/bias", "layers/mlp_dense_1/kernel")
# the runner methods that run on the whole state (`_whole`)
_WHOLE = ("evaluate", "_end_of_cycle", "save_ckpt", "load_ckpt",
          "estimate_variance", "evaluate_full_samples")


def make_tp_mesh(n_data: int, n_model: int) -> DeviceMesh:
    """('data', 'model') mesh over the first n_data * n_model ranks."""
    need = n_data * n_model
    if world_size() < need:
        raise ValueError(f"need {need} ranks for a ({n_data} data x "
                         f"{n_model} model) mesh, have {world_size()}")
    return DeviceMesh(_device_type(), torch.arange(need).view(n_data, n_model),
                      mesh_dim_names=("data", "model"))


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ModelParallel:
    """A rank's place in the 'model' group, and Megatron's f and g over it:
    the `tp` argument of the ViT."""

    def __init__(self, group):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def copy_in(self, x):
        return _CopyToModel.apply(x, self.group)

    def reduce_out(self, x):
        return _ReduceFromModel.apply(x, self.group)


def make_tp_constraints(mesh: DeviceMesh) -> ModelParallel:
    """The ViT's tensor parallelism over `mesh`'s 'model' axis (the JAX
    package's constrain_inner / constrain_outer pair)."""
    return ModelParallel(mesh.get_group("model"))


def wide_mask(model, dim: int, device) -> torch.Tensor:
    """Bool [dim]: the flat elements of the ViT's WIDE_LEAVES."""
    nested: dict = {}
    for name, p in model.named_parameters():
        *outer, leaf = name.split(".")
        node = nested
        for part in outer:
            node = node.setdefault(part, {})
        node[leaf] = p
    mask = torch.zeros(dim, dtype=torch.bool)
    for name, start, n in flat_util.leaf_spans(nested):
        if name in WIDE_LEAVES:
            mask[start:start + n] = True
    return mask.to(device)


def _write_back(shard: FlatShard, local, whole):
    """`local` (a shard state) <- `whole`'s values: the slices of its [D]
    tensors in place, its other values as they are."""
    if dataclasses.is_dataclass(local):
        for f in dataclasses.fields(local):
            a, b = getattr(local, f.name), getattr(whole, f.name)
            if isinstance(a, torch.Tensor) or dataclasses.is_dataclass(a):
                _write_back(shard, a, b)
            else:
                setattr(local, f.name, b)
    elif isinstance(local, torch.Tensor):
        local.copy_(shard.local(whole) if whole.shape != local.shape
                    else whole)


def shard_runner_for_tp(runner, mesh: DeviceMesh):
    """Shard a single-chain runner over the TP mesh, in place: its state,
    target and per-element vectors sliced evenly over every rank, its step
    on the rank's data slice of each batch, the methods of `_WHOLE` on the
    whole state.  The runner's ViT must have been built with
    `make_tp_constraints(mesh)`.  Returns the runner."""
    n_data, n_model = mesh.size(0), mesh.size(1)
    need = n_data * n_model
    group = dist.group.WORLD if need == world_size() else \
        dist.new_group(list(range(need)))
    target = runner.target
    shard = FlatShard(target.dim, shard_group=group, reduce_group=group,
                      n_data=n_data, n_model=n_model,
                      wide=wide_mask(target.module, target.dim,
                                     target.device))
    view = RunnerShard(runner, shard)
    whole = {"target": target, "shard": None,
             **{k: getattr(runner, k) for k in view.vectors}}
    sliced = {"target": view.target, "shard": shard, **view.vectors}
    runner.state = shard.local_state(runner.state)
    for k, v in sliced.items():
        setattr(runner, k, v)

    @contextlib.contextmanager
    def on_whole():
        """The runner on the whole state (gathered), its writes sliced back
        into the rank's state at the end."""
        if runner.shard is None:  # nested
            yield
            return
        local = runner.state
        runner.state = shard.full_state(local)
        for k, v in whole.items():
            setattr(runner, k, v)
        try:
            yield
        finally:
            _write_back(shard, local, runner.state)
            runner.state = local
            for k, v in sliced.items():
                setattr(runner, k, v)

    def on_whole_state(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with on_whole():
                return fn(*args, **kw)
        return call

    for name in _WHOLE:
        if hasattr(runner, name):
            setattr(runner, name, on_whole_state(getattr(runner, name)))

    data_group = mesh.get_group("data")
    data_rank = mesh.get_coordinate()[0]
    step = runner._step

    def data_step(state, ns, x, y, step_i, scalars):
        """The step on this data rank's slice of the batch; its loss
        averaged and its error summed over the data ranks."""
        b = x.shape[0]
        if b % n_data:
            raise ValueError(f"batch {b} does not split over {n_data} data "
                             f"ranks")
        lo, n = data_rank * (b // n_data), b // n_data
        state, ns, (loss, err) = step(state, ns, x[lo:lo + n], y[lo:lo + n],
                                      step_i, scalars)
        loss, err = loss.clone(), err.clone()
        dist.all_reduce(loss, group=data_group)
        dist.all_reduce(err, group=data_group)
        return state, ns, (loss / n_data, err)

    runner._step = data_step
    return runner
