"""Tensor-parallel (Megatron-style) ViT over a ('data', 'model') mesh
(counterpart of bayesdll_tpu.parallel.tp).

* The model: `make_tp_constraints(mesh)` gives the ViT its 'model' group
  (models/vit.py::ViT(tp=...)): column-parallel qkv (by heads) and
  mlp_dense_0, row-parallel out and mlp_dense_1, with Megatron's two
  functions: f, identity forward and a sum over the group backward, before
  each column-parallel product; g, a sum over the group forward and the
  identity backward, after each row-parallel one.  The JAX package gets
  the same placement from XLA through its activation constraints.  Remat
  checkpoints a tensor-parallel block as any other (models/vit.py).
* The sums are functional collectives (`_all_reduce`, a new tensor, not
  an in-place write), so selective checkpointing can save g's output and
  a recompute then reads it without running the collective again; and f
  and g carry `torch.func.vmap` rules that sum the stacked [B, ...] tensor
  in one collective (the sum is linear, so that is exact), so Laplace's
  vmapped per-example gradients run through the tensor-parallel forward.
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
* Evaluation, the cycle ends, Laplace's stage 2, cSGHMC-FS's snapshots and
  model average, and checkpoints run on the whole state, each rank
  gathering it (`_WHOLE`), every rank through the same tensor-parallel
  forward; what they change in the state is written back to the slices.
  There the target is `WholeTarget`, whose gradient sums the wide
  elements over the model group, so a gradient taken on the whole state
  (the Fisher) is the single process's; the runner's per-element vectors
  kept beside the state (`_WHOLE_ATTRS`: Laplace's MAP θ and variances)
  are gathered too.  Only rank 0 writes artifacts (the caller clears the
  others' workdir).

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
from bayesdll_tpu_torch.core.prior import FlatTarget
from bayesdll_tpu_torch.parallel.mesh import _device_type, world_size
from bayesdll_tpu_torch.parallel.shard import FlatShard, RunnerShard

# the ViT leaves sliced over the model ranks (models/vit.py::_block_tp)
WIDE_LEAVES = ("layers/attention/qkv/kernel", "layers/attention/qkv/bias",
               "layers/attention/out/kernel", "layers/mlp_dense_0/kernel",
               "layers/mlp_dense_0/bias", "layers/mlp_dense_1/kernel")
# the runner methods that run on the whole state (`on_whole`)
_WHOLE = ("evaluate", "_end_of_cycle", "save_ckpt", "load_ckpt",
          "estimate_variance", "evaluate_full_samples", "snapshot",
          "collect_full_sample")
# the runner's [D] vectors beside its state, whole inside `on_whole`
_WHOLE_ATTRS = ("map_theta", "post_vars")


def make_tp_mesh(n_data: int, n_model: int) -> DeviceMesh:
    """('data', 'model') mesh over the first n_data * n_model ranks."""
    need = n_data * n_model
    if world_size() < need:
        raise ValueError(f"need {need} ranks for a ({n_data} data x "
                         f"{n_model} model) mesh, have {world_size()}")
    return DeviceMesh(_device_type(), torch.arange(need).view(n_data, n_model),
                      mesh_dim_names=("data", "model"))


def _all_reduce(x, group):
    """The sum of x over `group`, as a new tensor (a functional
    collective: selective checkpointing can save its output)."""
    return torch.ops._c10d_functional.wait_tensor(
        torch.ops._c10d_functional.all_reduce(x, "sum", group.group_name))


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: sum over the group forward, identity backward."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        # the stacked examples summed in one collective
        return _ReduceFromModel.apply(x, group), in_dims[0]


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, sum over the group backward (g, so
    that the backward of a vmapped forward is one collective too)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _ReduceFromModel.apply(grad, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyToModel.apply(x, group), in_dims[0]


class _SumWideGrad(torch.autograd.Function):
    """Forward: θ as it is.  Backward: the whole gradient from a model
    rank's, which holds its columns of the wide leaves (zeros elsewhere in
    them) and the whole gradient of the other leaves: the wide elements
    summed over the model group (one rank's value and zeros, so exact),
    the others as they are."""

    @staticmethod
    def forward(theta, wide, group):
        return theta.view_as(theta)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.wide, ctx.group = inputs[1], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        summed = _ReduceFromModel.apply(grad, ctx.group)
        return torch.where(ctx.wide, summed, grad), None, None

    @staticmethod
    def vmap(info, in_dims, theta, wide, group):
        return _SumWideGrad.apply(theta, wide, group), in_dims[0]


@dataclasses.dataclass
class WholeTarget(FlatTarget):
    """A tensor-parallel rank's target on the whole θ: the FlatTarget's
    forward, its gradient the whole model's (`_SumWideGrad`)."""

    wide: torch.Tensor = None
    group: object = None

    def forward(self, theta, net_state, x, train: bool = False):
        return super().forward(_SumWideGrad.apply(theta, self.wide,
                                                  self.group),
                               net_state, x, train)


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
    whole_target = WholeTarget(
        **{f.name: getattr(target, f.name)
           for f in dataclasses.fields(FlatTarget)},
        wide=shard.wide, group=target.module.tp.group)
    whole = {"target": whole_target, "shard": None,
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
        for k in _WHOLE_ATTRS:  # a rank's slice, as the state's, set
            v = getattr(runner, k, None)  # outside: whole from here on
            if isinstance(v, torch.Tensor) and v.shape[0] == shard.size:
                setattr(runner, k, shard.gather(v))
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
