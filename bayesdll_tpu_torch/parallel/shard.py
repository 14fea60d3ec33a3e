"""A rank's part of a chain's flat vectors and of its gradient (the port's
form of the JAX package's shardings of the flat state, parallel/chains.py
and parallel/tp.py there).

A `FlatShard` says how one chain's [D] vectors lie over ranks and how its
gradient is assembled:
  * data parallel, replicated state: every rank of the chain's 'data' group
    holds the whole vector; the gradient of each rank's slice of the batch
    is summed over the group and divided by its size;
  * fsdp: the group's ranks hold the slices [r·D/n, (r+1)·D/n) of every
    [D] vector; the forward all-gathers θ, the backward sums the whole
    gradient over the group, divides it by the group's size and takes the
    rank's slice: the replicated run's bits, sliced;
  * tensor parallelism (parallel/tp.py): the vectors are sliced over every
    rank of the ('data', 'model') mesh; a model rank's gradient holds its
    slices of the wide weights and the whole of the others, so the world
    sum takes the wide elements as they are and the others divided by the
    model size (exact: the sizes are powers of 2 in practice, and the
    replicated elements are equal over the model ranks), then divides by
    the data size.

`ShardedTarget` is the target a rank steps on: θ0 and the masks sliced, its
forward all-gathering θ (`gather`), its backward reducing the gradient
(`reduce_grad`), both in one autograd Function, so a method's step takes
the gradient of its own slice as on one card.  `bind` puts it, the shard
and the runner's per-element vectors (`SHARDED_ATTRS`, sliced) in the
runner for the duration of a step; the runner's `draw_args` then hands the
kernels the shard's global offset, so the noise is the replicated run's.

Collectives run on the tensors' own device: NCCL on the card, or gloo (the
CPU tests, and several ranks sharing one card).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

from bayesdll_tpu_torch.core.prior import FlatTarget
from bayesdll_tpu_torch.utils import checkpoint as ckpt

# the runners' per-element vectors that a step reads: the lr vectors and
# the prior masks (methods/*.py)
SHARDED_ATTRS = ("lr_vec", "prior_mask", "mask", "kmask")


class FlatShard:
    """One rank's part of a chain's flat vectors of `total` elements.

    shard_group: the group over which the vectors are sliced, or None when
        every rank holds the whole vector.
    reduce_group: the group over which the gradient is summed.
    n_data: the divisor of that sum (the data-parallel size).
    wide: for tensor parallelism, the bool [D] mask of the elements sliced
        over the model ranks, and n_model their count.
    mesh: the 1-D DeviceMesh of shard_group, through which a checkpoint
        names each slice's global offset (`global_state`).
    """

    def __init__(self, total: int, *, shard_group=None, reduce_group=None,
                 n_data: int = 1, wide=None, n_model: int = 1, mesh=None):
        self.total = int(total)
        self.shard_group = shard_group
        self.mesh = mesh
        self.reduce_group = reduce_group
        self.n_data = int(n_data)
        self.wide, self.n_model = wide, int(n_model)
        if shard_group is None:
            self.n, self.rank = 1, 0
        else:
            self.n = dist.get_world_size(shard_group)
            self.rank = dist.get_rank(shard_group)
        if self.total % (4 * self.n):
            raise ValueError(f"a flat vector of {self.total} elements does "
                             f"not split into {self.n} shards of whole "
                             f"element quads")
        self.size = self.total // self.n
        self.elem0 = self.rank * self.size
        groups = [g for g in (shard_group, reduce_group) if g is not None]
        # a CUDA graph can hold NCCL's collectives, not gloo's
        self.capturable = all(dist.get_backend(g) == "nccl" for g in groups)

    @property
    def sharded(self) -> bool:
        return self.shard_group is not None

    def local(self, vec: torch.Tensor) -> torch.Tensor:
        """The rank's slice of a whole [D] vector, as its own tensor."""
        if not self.sharded:
            return vec
        return vec[self.elem0:self.elem0 + self.size].clone()

    def gather(self, vec: torch.Tensor) -> torch.Tensor:
        """The whole vector from the ranks' slices (a new tensor)."""
        if not self.sharded:
            return vec
        out = torch.empty(self.total, dtype=vec.dtype, device=vec.device)
        dist.all_gather(list(out.chunk(self.n)), vec.contiguous(),
                        group=self.shard_group)
        return out

    def reduce_grad(self, grad: torch.Tensor) -> torch.Tensor:
        """The gradient of the whole batch from each rank's whole-vector
        gradient of its slice of the batch: summed as the class docstring
        says, divided by n_data, the rank's slice taken."""
        g = grad.clone() if self.wide is None else torch.where(
            self.wide, grad, grad / self.n_model)
        if self.reduce_group is not None:
            dist.all_reduce(g, group=self.reduce_group)
        g = g / self.n_data
        if not self.sharded:
            return g
        return g[self.elem0:self.elem0 + self.size]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over the vector's elements from the rank's part of it."""
        if not self.sharded:
            return t
        t = t.clone()
        dist.all_reduce(t, group=self.shard_group)
        return t

    def map_state(self, fn, state, length: int):
        """`state` (a dataclass, dict or tensor, nested) with fn applied to
        every 1-D tensor of `length` elements; the rest as it is."""
        if isinstance(state, torch.Tensor):
            return fn(state) if state.dim() == 1 and \
                state.shape[0] == length else state
        if dataclasses.is_dataclass(state):
            return dataclasses.replace(state, **{
                f.name: self.map_state(fn, getattr(state, f.name), length)
                for f in dataclasses.fields(state)})
        if isinstance(state, dict):
            return {k: self.map_state(fn, v, length) for k, v in state.items()}
        return state

    def local_state(self, state):
        """A whole chain state's shard: every [D] leaf sliced."""
        return self.map_state(self.local, state, self.total)

    def global_state(self, state):
        """A shard state as a checkpoint writes and reads it: every sliced
        leaf the whole vector's DTensor over the live slice
        (utils/checkpoint.py::global_slice); the state itself when nothing
        is sliced."""
        if not self.sharded:
            return state
        return self.map_state(
            lambda t: ckpt.global_slice(t, self.total, self.mesh), state,
            self.size)

    def full_state(self, state):
        """A shard state's whole chain state: every sharded leaf gathered
        (new tensors; the state itself when nothing is sliced)."""
        if not self.sharded:
            return state
        return self.map_state(self.gather, state, self.size)


class _GatherFlat(torch.autograd.Function):
    """Forward: the whole θ from the rank's part.  Backward: the rank's part
    of the whole batch's gradient (FlatShard.reduce_grad)."""

    @staticmethod
    def forward(ctx, theta, shard):
        ctx.shard = shard
        full = shard.gather(theta)
        return full.view_as(full) if full is theta else full

    @staticmethod
    def backward(ctx, grad):
        return ctx.shard.reduce_grad(grad), None


@dataclasses.dataclass
class ShardedTarget(FlatTarget):
    """A FlatTarget on one rank's shard: θ0, is_head and is_bias sliced, the
    forward taking the rank's part of θ."""

    shard: FlatShard = None
    full: FlatTarget = None  # the whole-vector target

    def forward(self, theta, net_state, x, train: bool = False):
        return self.full.forward(_GatherFlat.apply(theta, self.shard),
                                 net_state, x, train)


def sharded_target(target: FlatTarget, shard: FlatShard) -> ShardedTarget:
    fields = {f.name: getattr(target, f.name)
              for f in dataclasses.fields(FlatTarget)}
    for name in ("theta0", "is_head", "is_bias"):
        fields[name] = shard.local(fields[name])
    return ShardedTarget(**fields, shard=shard, full=target)


class RunnerShard:
    """A runner's step on one rank's shard: its sharded target and sliced
    per-element vectors, which `bind` puts in the runner."""

    def __init__(self, runner, shard: FlatShard):
        self.shard = shard
        self.target = sharded_target(runner.target, shard)
        self.vectors = {name: shard.local(getattr(runner, name))
                        for name in SHARDED_ATTRS
                        if isinstance(getattr(runner, name, None),
                                      torch.Tensor)}

    @contextlib.contextmanager
    def bind(self, runner):
        saved = (runner.target, runner.shard,
                 {k: getattr(runner, k) for k in self.vectors})
        runner.target, runner.shard = self.target, self.shard
        for k, v in self.vectors.items():
            setattr(runner, k, v)
        try:
            yield runner
        finally:
            runner.target, runner.shard = saved[0], saved[1]
            for k, v in saved[2].items():
                setattr(runner, k, v)
