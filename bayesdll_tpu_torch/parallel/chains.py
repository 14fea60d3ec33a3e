"""Multi-chain training on one card (counterpart of
bayesdll_tpu.parallel.chains).

The JAX trainer runs C chains either as a vmap over a stacked state or, on
each device, one chain after another (its `_build_shardmap_scan`).  On one
card the port takes the second form as a host loop: each step runs the
method's own `_step` once per chain, on that chain's state, net_state and
batch, under the chain's seed (`BaseRunner.bound`), so every kernel is
launched once per chain per step, on the chain's own [D] vectors.  Chain c
draws everything from `core/rng.chain_seed(seed, c)`; a chain is therefore
the single-chain run that starts from its initial state, sees its batches
and has its seed.

Each chain starts from the runner's iterate plus 0.01·N(0, I), drawn on
the host from the chain's seed, and keeps its own net_state (BatchNorm
statistics).  Chains see their own data orders (`ArrayLoader.chain_view`).
The cyclical schedule is a function of the global step, shared by the
chains.

With `cfg.fused_steps` an epoch runs in fused segments, cut where the JAX
package cuts them (at cycle ends, and at a 256 MiB window of the chains'
stacked batches): a segment is chain 0's K steps, replays of its own CUDA
graph on the card (methods/graphed.py), then chain 1's, and so on, each on
the batches its own iterator gives it; the cyclical bookkeeping runs at
segment ends.  A chain's steps depend only on its own state, batches and
seed, so this order gives the per-step path's bits.

Not ported (ROADMAP.md): the mesh, data parallelism and fsdp
('Multi-device'); the chains' steps are not batched into one launch or one
vmapped forward (queue 2, 'Kernel work').
"""

from __future__ import annotations

import numpy as np
import torch

from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.methods import graphed

MULTI_DEVICE = ("ROADMAP.md queue 1, 'Multi-device': the port runs its "
                "chains on one card")


def clone_tree(tree):
    """A copy of a net_state: nested dicts of tensors."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


class MultiChainTrainer:
    """`n_chain` independent copies of a method runner's sampler step, one
    after another on the runner's device."""

    def __init__(self, runner, n_chain: int = None, *, fsdp: bool = False):
        if fsdp:
            raise NotImplementedError(f"fsdp: {MULTI_DEVICE}")
        self.runner = runner
        self.n_chain = int(n_chain or runner.cfg.num_chains)
        if self.n_chain < 1:
            raise ValueError(f"n_chain must be at least 1, got {n_chain}")
        self.seeds = [rng.chain_seed(runner.cfg.seed, c)
                      for c in range(self.n_chain)]
        self.states = [self._chain_init(s) for s in self.seeds]
        self.net_states = [clone_tree(runner.net_state)
                           for _ in range(self.n_chain)]
        self.bi = 0

    def _chain_init(self, seed: int):
        """A fresh state at the runner's iterate, jittered by 0.01·N(0, I)
        from the chain's seed so that the chains decorrelate."""
        r = self.runner
        state = r.init_state(r.iterate(r.state).clone())
        vec = r.iterate(state)
        z = torch.randn(vec.shape, generator=rng.generator("cpu", seed,
                                                           rng.JITTER))
        return r.with_iterate(state, vec + (0.01 * z).to(vec.device))

    def step(self, x, y, ep: int = 0):
        """One step of every chain at the global step self.bi of epoch ep;
        x[c], y[c] are chain c's batch.  Returns (loss [C], err [C]) on the
        device."""
        r = self.runner
        r.bi = self.bi  # the scalars read it
        scalars = r.step_scalars(ep)
        losses, errs = [], []
        for c in range(self.n_chain):
            with r.bound(self.states[c], self.net_states[c], self.seeds[c]):
                state, ns, (loss, err) = r._step(
                    r.state, r.net_state, r._to_device(x[c]),
                    r._to_device(y[c]), self.bi, scalars)
            self.states[c], self.net_states[c] = state, ns
            losses.append(loss)
            errs.append(err)
        self.bi += 1
        r.bi = self.bi
        return torch.stack(losses), torch.stack(errs)

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
        r = self.runner
        losses, errs = [], []
        for c in range(self.n_chain):
            with r.bound(self.states[c], self.net_states[c], self.seeds[c]):
                loss, err = r.run_steps(ep, xs[:, c], ys[:, c], bi0)
                self.states[c], self.net_states[c] = r.state, r.net_state
            losses.append(loss)
            errs.append(err)
        self.bi = r.bi = bi0 + len(xs)
        return torch.stack(losses, 1), torch.stack(errs, 1)

    def _epoch_begin_chains(self, ep: int):
        """The runner's epoch_begin on every chain (SGLD's family seeds its
        moments from the chain's iterate at the end of burn-in)."""
        r = self.runner
        for c in range(self.n_chain):
            with r.bound(self.states[c], self.net_states[c], self.seeds[c]):
                r.epoch_begin(ep)
                self.states[c], self.net_states[c] = r.state, r.net_state

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
                    loss, err = self.step([b[0] for b in batches],
                                          [b[1] for b in batches], ep)
                    losses.append(loss[None])
                    errs.append(err[None])
                    if after_batch is not None:
                        after_batch(ep)
            # the one host read of the epoch
            bs = train_loader.batch_size
            yield (ep, float(torch.cat(losses).mean()),
                   float(torch.cat(errs).float().mean()) / bs)

    def _train_one_epoch_fused(self, ep: int, train_loader, after_batch):
        """The epoch in fused segments (JAX `MultiChainTrainer.
        _train_one_epoch_fused`): cut after each of the runner's
        `segment_ends` and when the chains' stacked batches reach its
        FUSED_BYTES_BUDGET, `after_batch` at segment ends only.  Returns
        the per-step (loss, err) as lists of [K, C]."""
        r = self.runner
        n = len(train_loader)
        r.bi = self.bi
        its = self._chain_iters(train_loader, ep)

        def batches():  # every chain's next batch, stacked [C, B, ...]
            for _ in range(n):
                chain = [next(it) for it in its]
                yield (np.stack([b[0] for b in chain]),
                       np.stack([b[1] for b in chain]))
        losses, errs = [], []
        for xs, ys, at_end in graphed.segments(
                batches(), n, r.segment_ends(ep, n), r.FUSED_BYTES_BUDGET):
            loss_k, err_k = self.run_steps(ep, xs, ys, self.bi)
            losses.append(loss_k)
            errs.append(err_k)
            if at_end and after_batch is not None:
                after_batch(ep)
        return losses, errs

    def _chain_iters(self, train_loader, ep: int):
        """One epoch iterator per chain: `chain_view(c, ep)` where the
        loader has it (an order that is a function of chain and epoch
        only), else the loader's own shared iterator order."""
        cv = getattr(train_loader, "chain_view", None)
        if cv is None:
            return [iter(train_loader) for _ in range(self.n_chain)]
        return [iter(cv(c, ep)) for c in range(self.n_chain)]

    def reset_cycle_moments(self):
        """Empty moments on every chain (a cycle's start), cleared in
        place."""
        self.states = [self.runner._reset_cycle_state(s) for s in self.states]

    def iterates(self) -> torch.Tensor:
        """The chains' iterates, [C, D]."""
        return torch.stack([self.runner.iterate(s) for s in self.states])

    def chain_mean_vars(self):
        """Every chain's (mean, var) from its moments, [C, D] each."""
        mv = [s.moments.mean_var() for s in self.states]
        return (torch.stack([m for m, _ in mv]),
                torch.stack([v for _, v in mv]))
