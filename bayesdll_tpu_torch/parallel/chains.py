"""Multi-chain training, on one card or over ranks (counterpart of
bayesdll_tpu.parallel.chains).

The JAX trainer runs C chains either as a vmap over a stacked state or, on
each device, one chain after another (its `_build_shardmap_scan`).  The
port takes the second form as a host loop: each step runs the method's own
`_step` once per chain, on that chain's state, net_state and batch, under
the chain's seed (`BaseRunner.bound`), so every kernel is launched once per
chain per step, on the chain's own vectors.  Chain c draws everything from
`core/rng.chain_seed(seed, c)`; a chain is therefore the single-chain run
that starts from its initial state, sees its batches and has its seed.

Each chain starts from the runner's iterate plus 0.01·N(0, I), drawn on
the host from the chain's seed, and keeps its own net_state (BatchNorm
statistics).  Chains see their own data orders (`ArrayLoader.chain_view`).
The cyclical schedule is a function of the global step, shared by the
chains.

Over ranks (`mesh`, a ('chain', 'data') DeviceMesh from parallel/mesh.py),
as the JAX package's P('chain', 'data') shardings place it:
  * chain coordinate i holds chains [i·k, (i+1)·k), k = C / chain axis,
    each keeping its global index c (seed, jitter, data order), so chain c
    is bitwise its single-process run;
  * a chain's batch [B, ...] is split contiguously over its 'data' ranks
    (B % n_data == 0); the gradient is summed over them and divided by
    n_data before the update, which then runs identically on every data
    rank from the same seed; BatchNorm takes its statistics over the whole
    chain batch (models/layers.py::BatchNorm's group);
  * with fsdp every [D] vector of a chain state (θ, momenta, moments,
    Adam's m and v2, VI's mean and scale) is held as the rank's slice
    [r·D/n, (r+1)·D/n), as are the target's θ0 and masks and the runner's
    lr vectors; the forward all-gathers θ, the backward reduces the whole
    gradient and takes the slice, and the update kernels run on the slice
    at its global offset (parallel/shard.py).  A D that does not split
    into whole element quads replicates, as the JAX package replicates a
    leaf of another length;
  * a step's loss and error are averaged (summed) over the data ranks and
    gathered over the chain ranks, so every rank reads every chain's, as
    the JAX trainer's replicated outputs are read.
Without a mesh nothing is reduced or gathered, and fsdp has nothing to
shard over.

With `cfg.fused_steps` an epoch runs in fused segments, cut where the JAX
package cuts them (at cycle ends, and at a 256 MiB window of the chains'
stacked batches): a segment is chain 0's K steps, replays of its own CUDA
graph on the card (methods/graphed.py), then chain 1's, and so on, each on
the batches its own iterator gives it; the cyclical bookkeeping runs at
segment ends.  A chain's steps depend only on its own state, batches and
seed, so this order gives the per-step path's bits.  Over ranks the choice
of graph is the backend's: NCCL's collectives are captured into the step's
graph and replay with it; gloo's run on the host and cannot be captured,
so with gloo the segment's steps run eagerly on the same static buffers
(`FlatShard.capturable`).  Either way a fused segment computes the
per-step path's bits.

Not ported (ROADMAP.md queue 2, 'Kernel work'): the chains' steps are not
batched into one launch or one vmapped forward.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch
import torch.distributed as dist

from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.methods import base, graphed
from bayesdll_tpu_torch.models.layers import set_batch_norm_group
from bayesdll_tpu_torch.parallel.shard import FlatShard, RunnerShard
from bayesdll_tpu_torch.utils import profiling

_LOG = logging.getLogger("bayesdll_tpu_torch")


def clone_tree(tree):
    """A copy of a net_state: nested dicts of tensors."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


class MultiChainTrainer:
    """`n_chain` independent copies of a method runner's sampler step, one
    after another on the runner's device, over the ranks of `mesh` when
    one is given."""

    def __init__(self, runner, n_chain: int = None, *, mesh=None,
                 fsdp: bool = False):
        self.runner = runner
        self.n_chain = int(n_chain or runner.cfg.num_chains)
        if self.n_chain < 1:
            raise ValueError(f"n_chain must be at least 1, got {n_chain}")
        self.mesh, self.fsdp = mesh, bool(fsdp)
        self.chains = list(range(self.n_chain))  # this rank's, global
        self.n_data, self.data_rank = 1, 0
        self.chain_group = self.data_group = None
        self.shard = self.view = None
        if mesh is not None:
            self._place(mesh)
        self.all_seeds = [rng.chain_seed(runner.cfg.seed, c)
                          for c in range(self.n_chain)]
        self.seeds = [self.all_seeds[c] for c in self.chains]
        self.states = [self.local_state(self._chain_init(s))
                       for s in self.seeds]
        self.net_states = [clone_tree(runner.net_state) for _ in self.chains]
        self.bi = 0

    def _place(self, mesh):
        """This rank's chains, data slice, groups and shard in `mesh`."""
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the ('chain', 'data') mesh")
        axis, self.n_data = mesh.size(0), mesh.size(1)
        if self.n_chain % axis:
            raise ValueError(
                f"n_chain={self.n_chain} must be a multiple of the mesh "
                f"'chain' axis ({axis}) so P('chain') shards evenly")
        k = self.n_chain // axis
        self.chains = list(range(coord[0] * k, (coord[0] + 1) * k))
        self.data_rank = coord[1]
        self.chain_group = mesh.get_group("chain")
        self.data_group = mesh.get_group("data")
        r = self.runner
        dim = r.target.dim
        split = self.fsdp and dim % (4 * self.n_data) == 0
        if self.fsdp and not split:
            _LOG.info("fsdp: D=%d does not split into %d shards of whole "
                      "element quads; the state replicates", dim, self.n_data)
        self.shard = FlatShard(dim, reduce_group=self.data_group,
                               shard_group=self.data_group if split else None,
                               n_data=self.n_data,
                               mesh=mesh["data"] if split else None)
        self.view = RunnerShard(r, self.shard)
        if self.n_data > 1:
            set_batch_norm_group(r.target.module, self.data_group)

    def _chain_init(self, seed: int):
        """A fresh state at the runner's iterate, jittered by 0.01·N(0, I)
        from the chain's seed so that the chains decorrelate."""
        r = self.runner
        state = r.init_state(r.iterate(r.state).clone())
        vec = r.iterate(state)
        z = torch.randn(vec.shape, generator=rng.generator("cpu", seed,
                                                           rng.JITTER))
        return r.with_iterate(state, vec + (0.01 * z).to(vec.device))

    # ---- this rank's part -----------------------------------------------------

    def local_state(self, state):
        """A whole chain state as this rank holds it (its fsdp shard)."""
        return state if self.shard is None else self.shard.local_state(state)

    def local_vector(self, vec: torch.Tensor) -> torch.Tensor:
        """A whole [D] vector as this rank holds it."""
        return vec if self.shard is None else self.shard.local(vec)

    def full_state(self, i: int):
        """Local chain i's whole state (gathered over the data ranks under
        fsdp; its own state otherwise)."""
        s = self.states[i]
        return s if self.shard is None else self.shard.full_state(s)

    def _part(self, a, axis: int = 0):
        """This data rank's contiguous slice of the batch axis `axis` of a
        chain batch ([B, ...] at axis 0)."""
        if self.n_data == 1:
            return a
        b = a.shape[axis]
        if b % self.n_data:
            raise ValueError(f"batch {b} does not split over {self.n_data} "
                             f"data ranks")
        n = b // self.n_data
        lo = self.data_rank * n
        return a[(slice(None),) * axis + (slice(lo, lo + n),)]

    @contextlib.contextmanager
    def _bound(self, i: int):
        """The runner on local chain i: its state, net_state and seed, and
        over ranks its shard."""
        r = self.runner
        with r.bound(self.states[i], self.net_states[i], self.seeds[i]):
            if self.view is None:
                yield r
            else:
                with self.view.bind(r):
                    yield r

    # ---- every chain, on every rank -------------------------------------------

    def gather_chains(self, local: list) -> list:
        """Per-chain host objects of this rank's chains -> those of every
        chain in chain order, on every rank (identity without a mesh)."""
        if self.mesh is None:
            return list(local)
        out = [None] * dist.get_world_size(self.chain_group)
        dist.all_gather_object(out, list(local), group=self.chain_group)
        return [obj for part in out for obj in part]

    def gather_trees(self, local: list) -> list:
        """Tensor trees (states, net_states) of this rank's chains -> every
        chain's, on this rank's device."""
        if self.mesh is None:
            return list(local)
        every = self.gather_chains([base.to_host(t) for t in local])
        return [base.from_host(local[0], t, self.runner.device)
                for t in every]

    def all_chains(self, states: bool = True):
        """(states, net_states, seeds) of every chain, whole, on every rank
        (states None when not asked for)."""
        if self.mesh is None:
            return (self.states if states else None), self.net_states, \
                self.seeds
        full = self.gather_trees([self.full_state(i)
                                  for i in range(len(self.chains))]) \
            if states else None
        return full, self.gather_trees(self.net_states), self.all_seeds

    def _reduce(self, loss, err, dim: int):
        """Local chains' (loss, err) -> every chain's: the loss averaged and
        the error count summed over the data ranks, both gathered over the
        chain ranks along `dim`."""
        if self.mesh is None:
            return loss, err
        loss, err = loss.contiguous(), err.contiguous()
        dist.all_reduce(loss, group=self.data_group)
        dist.all_reduce(err, group=self.data_group)
        loss = loss / self.n_data

        def gather(t):
            parts = [torch.empty_like(t) for _ in
                     range(dist.get_world_size(self.chain_group))]
            dist.all_gather(parts, t, group=self.chain_group)
            return torch.cat(parts, dim)
        return gather(loss), gather(err)

    # ---- steps ----------------------------------------------------------------

    def step(self, x, y, ep: int = 0):
        """One step of every chain at the global step self.bi of epoch ep;
        x[c], y[c] are chain c's batch (this rank reads its own chains' and
        its slice of each).  Returns (loss [C], err [C]) on the device."""
        return self._step_local([x[c] for c in self.chains],
                                [y[c] for c in self.chains], ep)

    def _step_local(self, xs, ys, ep: int):
        """One step of this rank's chains, xs[i] local chain i's batch."""
        r = self.runner
        r.bi = self.bi  # the scalars read it
        scalars = r.step_scalars(ep)
        losses, errs = [], []
        for i in range(len(self.chains)):
            with self._bound(i):
                state, ns, (loss, err) = r._step(
                    r.state, r.net_state, r._to_device(self._part(xs[i])),
                    r._to_device(self._part(ys[i])), self.bi, scalars)
            self.states[i], self.net_states[i] = state, ns
            losses.append(loss)
            errs.append(err)
        self.bi += 1
        r.bi = self.bi
        return self._reduce(torch.stack(losses), torch.stack(errs), 0)

    def step_loop(self, ep: int, xs, ys, bi0: int):
        """len(xs) per-step steps of every chain from global step bi0, with
        no host hooks in between.  xs: [K, C, B, ...], ys: [K, C, B].
        Returns (loss, err), [K, C] each, on the device."""
        self.bi = bi0
        out = [self.step(xs[k], ys[k], ep) for k in range(len(xs))]
        return (torch.stack([o[0] for o in out]),
                torch.stack([o[1] for o in out]))

    def run_steps(self, ep: int, xs, ys, bi0: int):
        """len(xs) fused steps of every chain from global step bi0 (the JAX
        package's scanned segment): chain c's K steps through the runner's
        `run_steps` on its state, net_state and seed, one chain after
        another.  xs: [K, C, B, ...], ys: [K, C, B].  Returns (loss, err),
        [K, C] each, on the device."""
        if self.mesh is not None:
            xs, ys = xs[:, self.chains], ys[:, self.chains]
        return self._run_steps_local(ep, xs, ys, bi0)

    def _run_steps_local(self, ep: int, xs, ys, bi0: int):
        """run_steps of this rank's chains, xs [K, k, B, ...]."""
        r = self.runner
        xs, ys = self._part(xs, 2), self._part(ys, 2)
        losses, errs = [], []
        for i in range(len(self.chains)):
            with self._bound(i):
                loss, err = r.run_steps(ep, xs[:, i], ys[:, i], bi0)
                self.states[i], self.net_states[i] = r.state, r.net_state
            losses.append(loss)
            errs.append(err)
        self.bi = r.bi = bi0 + len(xs)
        return self._reduce(torch.stack(losses, 1), torch.stack(errs, 1), 1)

    def _epoch_begin_chains(self, ep: int):
        """The runner's epoch_begin on every chain (SGLD's family seeds its
        moments from the chain's iterate at the end of burn-in)."""
        r = self.runner
        for i in range(len(self.chains)):
            with self._bound(i):
                r.epoch_begin(ep)
                self.states[i], self.net_states[i] = r.state, r.net_state

    def train_epochs(self, train_loader, epochs: int, after_batch=None,
                     start_epoch: int = 0):
        """Yields (epoch, mean loss, mean error) over the chains' steps.
        Each chain takes its own pass over the data; `after_batch(ep)` runs
        after every step (the cyclical bookkeeping)."""
        for ep in range(start_epoch, epochs):
            self._epoch_begin_chains(ep)
            if self.runner.use_fused(ep):
                losses, errs = self._train_one_epoch_fused(ep, train_loader,
                                                           after_batch)
            else:
                its = self._chain_iters(train_loader, ep)
                losses, errs = [], []
                for _ in range(len(train_loader)):
                    batches = [next(it) for it in its]
                    loss, err = self._step_local([b[0] for b in batches],
                                                 [b[1] for b in batches], ep)
                    losses.append(loss[None])
                    errs.append(err[None])
                    if after_batch is not None:
                        after_batch(ep)
            # the one host read of the epoch
            bs = train_loader.batch_size
            profiling.host_sync("epoch", 2)
            yield (ep, float(torch.cat(losses).mean()),
                   float(torch.cat(errs).float().mean()) / bs)

    def _train_one_epoch_fused(self, ep: int, train_loader, after_batch):
        """The epoch in fused segments (JAX `MultiChainTrainer.
        _train_one_epoch_fused`): cut after each of the runner's
        `segment_ends` and when this rank's chains' stacked batches reach
        its FUSED_BYTES_BUDGET, `after_batch` at segment ends only.
        Returns the per-step (loss, err) as lists of [K, C]."""
        r = self.runner
        n = len(train_loader)
        r.bi = self.bi
        its = self._chain_iters(train_loader, ep)

        def batches():  # every local chain's next batch, stacked [k, B, ...]
            for _ in range(n):
                chain = [next(it) for it in its]
                yield (np.stack([b[0] for b in chain]),
                       np.stack([b[1] for b in chain]))
        losses, errs = [], []
        for xs, ys, at_end in graphed.segments(
                batches(), n, r.segment_ends(ep, n), r.FUSED_BYTES_BUDGET):
            loss_k, err_k = self._run_steps_local(ep, xs, ys, self.bi)
            losses.append(loss_k)
            errs.append(err_k)
            if at_end and after_batch is not None:
                after_batch(ep)
        return losses, errs

    def _chain_iters(self, train_loader, ep: int):
        """One epoch iterator per local chain: `chain_view(c, ep)` where the
        loader has it (an order that is a function of chain and epoch
        only), else the loader's own shared iterator order."""
        cv = getattr(train_loader, "chain_view", None)
        if cv is None:
            return [iter(train_loader) for _ in self.chains]
        return [iter(cv(c, ep)) for c in self.chains]

    def reset_cycle_moments(self):
        """Empty moments on every chain (a cycle's start), cleared in
        place."""
        self.states = [self.runner._reset_cycle_state(s) for s in self.states]

    def iterates(self) -> torch.Tensor:
        """Every chain's iterate, whole, [C, D]."""
        states = self.all_chains()[0]
        return torch.stack([self.runner.iterate(s) for s in states])

    def chain_mean_vars(self):
        """Every chain's (mean, var) from its moments, whole, [C, D] each."""
        mv = [s.moments.mean_var() for s in self.all_chains()[0]]
        return (torch.stack([m for m, _ in mv]),
                torch.stack([v for _, v in mv]))
