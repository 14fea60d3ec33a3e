"""Multi-chain runner: the train / eval / calibrate workflow of C chains on
one card or over the ranks of a ('chain', 'data') mesh (counterpart of
bayesdll_tpu.parallel.runner).

Wraps a single-chain runner of any of the eleven methods with:
  * the chains' training (parallel/chains.py);
  * a combined predictive that treats the chains as more posterior samples:
    for the cyclical methods a chains x cycles mixture (each chain's GMM
    weights over its cycles, the chains weighted equally); for Laplace
    after stage 2 a mixture of the chains' N(θ_MAP, vars); for every other
    method and state each chain's own predictive (its `pred_state` and
    `_predict_logits`), the chains' samples pooled;
  * per chain, as the single-chain runners do it: the cycle-end snapshot
    and full-train likelihoods, the cycle-start resets and cold restarts,
    Laplace's best-val iterate and stage-2 Fisher, cSGHMC-FS's snapshots
    and their model average;
  * BaseRunner's best-checkpoint, calibration and artifact protocol, and a
    checkpoint that resumes bit for bit: the pickle `chains_ckpt.pkl`, or
    with `ckpt_backend="orbax"` the directory `chains_ckpt_orbax`, which
    is a `torch.distributed.checkpoint` (DCP) directory, not orbax's
    (utils/checkpoint.py), beside its `chains_ckpt_orbax.meta.pkl`.  The
    JAX package's names stay, so one command line and one --resume path
    serve both packages.

Chain c's draws come from its own seed (trainer.all_seeds[c]): its eval
and likelihood draws are those of a single-chain run with that seed.
Every chain forwards with its own net_state.

Over ranks each rank trains its own chains (parallel/chains.py), and what
evaluation and the cycle ends need of every chain is gathered, as the JAX
package's `_fetch_global` gathers it: the cycle-end moments and
likelihoods (each rank computes its own chains', from their whole vectors
under fsdp), Laplace's stage-2 means and variances, the chains' states and
net_states for the predictive.  Every rank then evaluates every chain on
the same data and reads the same NLL.  The DCP checkpoint keys each chain
by its global index and each vector by its field, whatever the layout; an
fsdp shard goes in as the whole vector's DTensor over the rank's slice
(parallel/shard.py::FlatShard.global_state), a replicated vector and the
net_states as plain tensors, which DCP keeps once.  Each rank saves and
loads its own chains or slices, rank 0 writes the sidecar after the save,
behind a barrier.  So a directory restores at any layout with the same
chains (the JAX package's orbax template carries the live shardings, as
the port's DTensors do): saved by 2 fsdp ranks, it resumes in one process
without fsdp, on 4 ranks, or with its chains on other ranks.  The sidecar
records the padded length, the parameter count and the layout that wrote
it; a padded length other than the runner's raises before a tensor is
read.  A forced pickle gathers every chain's
whole state into the file each process writes (one path: the writes are
atomic, of the same bytes).  Only rank 0 writes the other artifacts.
"""

from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.methods.cyclical_base import gmm_weights_of
from bayesdll_tpu_torch.parallel.chains import MultiChainTrainer, clone_tree
from bayesdll_tpu_torch.utils import checkpoint as ckpt


class MultiChainRunner:
    def __init__(self, runner, n_chain: int = None, *, logger=None,
                 workdir=None, fsdp: bool = False, mesh=None):
        self.runner = runner
        self.trainer = MultiChainTrainer(runner, n_chain, mesh=mesh,
                                         fsdp=fsdp)
        self.logger = logger or runner.logger
        self.workdir = workdir or runner.workdir
        # the rank that writes the artifacts; the others keep the workdir
        # for the DCP checkpoint, which every rank writes
        self.writer = not dist.is_initialized() or dist.get_rank() == 0
        if not self.writer:
            runner.workdir = None
        if self.workdir:
            os.makedirs(self.workdir, exist_ok=True)
        self.cfg = runner.cfg
        self.device = runner.device
        self.results = {}
        self._la_stage2 = None  # (means [C, D], vars [C, D]) after stage 2
        self._la_net_states = None  # every chain's, for stage 2's mixture
        self._la_best = None  # [losses [C], thetas [C], net_states [C]]
        self._is_cyclical = hasattr(runner, "_ensure_sched")
        self.chain_cycle_stats = []  # chain -> cycle -> stats
        self._train_loader = None
        # the shared train loader's RandomState at the checkpoint, which
        # load_ckpt hands to the next `train` (see `_meta`)
        self._loader_rng = None

    # BaseRunner's best-eval, artifact and calibration protocol, as is
    _eval_and_maybe_save = base.BaseRunner._eval_and_maybe_save
    _calibrate = base.BaseRunner._calibrate
    save_logits = base.BaseRunner.save_logits
    _predictive_loop = base.BaseRunner._predictive_loop
    _to_device = base.BaseRunner._to_device

    def train(self, train_loader, val_loader, test_loader, start_epoch=0):
        cfg, logger, r, tr = self.cfg, self.logger, self.runner, self.trainer
        self._train_loader = train_loader
        if self._loader_rng is not None:
            train_loader._rng.set_state(self._loader_rng)
            self._loader_rng = None
        if self._is_cyclical:
            r._ensure_sched(len(train_loader))
            r._train_loader = train_loader
            if not self.chain_cycle_stats:  # load_ckpt may have filled it
                self.chain_cycle_stats = [{} for _ in range(tr.n_chain)]
        logger.info("Start multi-chain training: %d chains x %d data shards "
                    "on %s", tr.n_chain, tr.n_data, self.device)
        best_loss = np.inf
        tic0 = time.time()
        is_la = hasattr(r, "estimate_variance")
        self._la_best = None
        after_batch = self._cyclical_after_batch if self._is_cyclical \
            else None
        losses, errs = [], []
        for ep, loss, err in tr.train_epochs(train_loader, cfg.epochs,
                                             after_batch=after_batch,
                                             start_epoch=start_epoch):
            losses.append(loss)
            errs.append(err)
            logger.info("[Epoch %d/%d] multi-chain mean loss = %.4f, "
                        "prediction error = %.4f", ep, cfg.epochs, loss, err)
            if is_la:
                self._track_la_best(val_loader or test_loader, ep)
            if hasattr(r, "multi_chain_epoch_end"):
                r.multi_chain_epoch_end(self, ep)
            ready = any(self.chain_cycle_stats) if self._is_cyclical \
                else r.eval_ready(ep)
            if ep % cfg.test_eval_freq == 0 and ready \
                    and test_loader is not None:
                best_loss = self._eval_and_maybe_save(
                    ep, val_loader, test_loader, best_loss)
        self.results.update(train_losses=losses, train_errors=errs)

        if is_la:
            # Laplace's stage 2 on each chain's best-val iterate, then the
            # final eval with the chains' Laplace mixture
            self._la_stage2 = self._chain_laplace(train_loader)
            if test_loader is not None:
                best_loss = self._eval_and_maybe_save(
                    cfg.epochs - 1, val_loader, test_loader, np.inf)

        if getattr(r, "full_samples", None):
            # cSGHMC-FS: the model average over every chain's snapshots
            self.results["bma"] = r.evaluate_full_samples(
                train_loader, val_loader, test_loader)

        self.results.setdefault("best_loss", float(best_loss))
        self.results["total_time"] = time.time() - tic0
        self.save_ckpt(cfg.epochs - 1)
        return self.results

    # ---- Laplace --------------------------------------------------------------

    @torch.no_grad()
    def _per_chain_point_losses(self, loader) -> np.ndarray:
        """[k] mean CE of each of this rank's chains' iterates over `loader`
        (eval mode, its own net_state)."""
        r, tr = self.runner, self.trainer
        k = len(tr.chains)
        thetas = [r.iterate(tr.full_state(i)) for i in range(k)]
        tot = [torch.zeros((), device=self.device) for _ in range(k)]
        n = 0.0
        for x, y, valid in loader:
            xd, yd = self._to_device(x), self._to_device(y).long()
            vd = self._to_device(valid)
            for c in range(k):
                logits, _ = r.target.forward(thetas[c], tr.net_states[c], xd,
                                             train=False)
                picked = torch.log_softmax(logits, -1).gather(
                    1, yd[:, None])[:, 0]
                tot[c] += torch.sum(-picked * vd)
            n += float(valid.sum())
        return np.array([float(t) for t in tot]) / max(n, 1.0)

    def _track_la_best(self, loader, ep: int):
        """Each of this rank's chains' best-val iterate (whole) and its
        net_state (copies), which stage 2 takes as the MAP, as the reference
        reloads its best checkpoint (`methods/la.py:124-143`)."""
        if loader is None:
            return  # stage 2 then takes the final iterates
        tr = self.trainer
        k = len(tr.chains)
        losses = self._per_chain_point_losses(loader)
        if self._la_best is None:
            self._la_best = [losses, [None] * k, [None] * k]
            improved = np.ones(k, bool)
        else:
            improved = losses < self._la_best[0]
            if improved.any():
                self.logger.info(
                    "LA best-val improved on chains %s at epoch %d",
                    [tr.chains[i] for i in np.nonzero(improved)[0]], ep)
        best_l, best_t, best_ns = self._la_best
        for i in np.nonzero(improved)[0]:
            best_l[i] = losses[i]
            best_t[i] = self.runner.iterate(tr.full_state(i)).clone()
            best_ns[i] = clone_tree(tr.net_states[i])

    def _chain_laplace(self, train_loader):
        """Stage 2 per chain, one after another (each rank its own chains):
        the diagonal Fisher at the chain's best-val iterate (else its final
        one) with the matching net_state.  Returns every chain's (means,
        vars), [C, D] each, and keeps their net_states in _la_net_states."""
        r, tr = self.runner, self.trainer
        means, vars_, secs, nss = [], [], [], []
        saved_map = r.map_theta
        try:
            for i, c in enumerate(tr.chains):
                full = tr.full_state(i)
                if self._la_best is not None:
                    theta, ns = self._la_best[1][i], self._la_best[2][i]
                else:
                    theta, ns = r.iterate(full), tr.net_states[i]
                self.logger.info("LA stage 2: Fisher for chain %d/%d", c,
                                 tr.n_chain)
                tic = time.time()
                with r.bound(full, ns, tr.seeds[i]):
                    r.map_theta = theta
                    vars_.append(r.estimate_variance(train_loader))
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                secs.append(time.time() - tic)
                means.append(theta)
                nss.append(ns)
        finally:
            r.map_theta = saved_map
        self.results["fisher_time_per_chain"] = tr.gather_chains(secs)
        mv = tr.gather_trees([{"m": m, "v": v} for m, v in zip(means, vars_)])
        self._la_net_states = tr.gather_trees(nss)
        return (torch.stack([t["m"] for t in mv]),
                torch.stack([t["v"] for t in mv]))

    # ---- the cyclical methods, per chain ----------------------------------------

    def _cyclical_after_batch(self, ep: int):
        """At a cycle's last step, on every chain: its cycle's moments and
        full-train likelihoods (`_chain_likelihoods`; each rank its own
        chains', gathered), then fresh moments and the method's cycle-start
        reset."""
        r, tr = self.runner, self.trainer
        step = tr.bi - 1
        if not r.sched.last_in_cycle_py(step):
            return
        cycle = r.sched.cycle_number_py(step)
        full = [tr.full_state(i) for i in range(len(tr.chains))]
        liks = self._chain_likelihoods(full)
        stats = []
        for state, lik in zip(full, liks):
            mean, var = state.moments.mean_var()
            stats.append({"mean": base.to_host(mean), "var": base.to_host(var),
                          "n": int(r._moments_count(state)),
                          "likelihoods": lik})
        liks = []
        for c, st in enumerate(tr.gather_chains(stats)):
            self.chain_cycle_stats[c][cycle] = st
            liks.append(st["likelihoods"])
        self.logger.info(
            "Completed cycle %d on %d chains (mean likelihood %.3e)",
            cycle, tr.n_chain, float(np.mean([lk.mean() for lk in liks])))
        tr.reset_cycle_moments()
        r.multi_chain_cycle_start(tr, cycle + 1)

    def _chain_likelihoods(self, states=None):
        """Each of this rank's chains' full-train likelihoods of nst samples
        around its LIK_CENTER with its cycle's variance (`states` its whole
        states, gathered when not given), every chain on the same examples
        (one pass over the loader), with its own net_state and its own
        draws."""
        tr = self.trainer
        if states is None:
            states = [tr.full_state(i) for i in range(len(tr.chains))]
        return self.runner.chains_likelihoods(
            self._train_loader, list(zip(states, tr.net_states, tr.seeds)))

    def gmm_weights_per_chain(self):
        """Each chain's GMM weights over its cycles, normalised within the
        chain (reference `methods/csgld.py:565-594`)."""
        return [gmm_weights_of(stats) for stats in self.chain_cycle_stats]

    # ---- checkpoint -------------------------------------------------------------

    def _use_orbax(self) -> bool:
        """The checkpoint backend: `ckpt_backend="orbax"` forces the DCP
        directory and "pickle" the pickle; the default "auto" picks the
        directory when a process group spans processes, where the pickle
        would gather every chain's state into one process's file."""
        if self.cfg.ckpt_backend == "auto":
            return dist.is_initialized() and dist.get_world_size() > 1
        return self.cfg.ckpt_backend == "orbax"

    def _meta(self, ep: int) -> dict:
        """What a resume needs beside the chains' tensors.  The chains'
        batches come from `chain_view(c, epoch)`, a function of chain and
        epoch; the cycle ends' likelihood passes iterate the shared train
        loader, whose RandomState each pass advances (its shuffle, with
        drop_last, picks the examples), so its state is saved too: a
        resumed run's passes then see the uninterrupted run's examples."""
        tr = self.trainer
        target = self.runner.target
        rng_ = getattr(self._train_loader, "_rng", None)
        return {"epoch": ep, "bi": tr.bi, "method": self.runner.method_name,
                "n_chain": tr.n_chain, "seeds": tr.all_seeds,
                "dim": target.dim, "n_params": target.n_params,
                "layout": {"world": dist.get_world_size()
                           if dist.is_initialized() else 1,
                           "chain_axis": 1 if tr.mesh is None
                           else tr.mesh.size(0),
                           "n_data": tr.n_data,
                           "fsdp": tr.shard is not None and tr.shard.sharded},
                "chain_cycle_stats": self.chain_cycle_stats,
                "train_loader_rng": None if rng_ is None else rng_.get_state()}

    def _check_meta(self, meta: dict):
        """The checkpoint's chains and flat length are the runner's, before
        a tensor is read."""
        tr = self.trainer
        if meta["n_chain"] != tr.n_chain:
            raise ValueError(
                f"checkpoint has {meta['n_chain']} chains, runner has "
                f"{tr.n_chain}; restart with matching --num_chains")
        if meta["seeds"] != tr.all_seeds:
            raise ValueError("checkpoint's chain seeds differ from the "
                             "runner's; restart with the run's --seed")
        dim = self.runner.target.dim
        if meta.get("dim", dim) != dim:
            raise ValueError(
                f"checkpoint's flat vectors hold {meta['dim']} elements, the "
                f"runner's {dim}: the padded length depends on the world "
                f"size that built the target (cli/demo.py pads to lcm(1024, "
                f"4 x world)); resume at a world that pads to {meta['dim']}")

    def _loaded(self, meta: dict, path: str) -> int:
        tr = self.trainer
        tr.bi = self.runner.bi = int(meta.get("bi", 0))
        self.chain_cycle_stats = meta.get("chain_cycle_stats", [])
        self._loader_rng = meta.get("train_loader_rng")
        self.logger.info("Multi-chain checkpoint loaded from %s (epoch %d, "
                         "step %d)", path, meta["epoch"], tr.bi)
        return meta["epoch"]

    def save_ckpt(self, ep: int, fname: str = "chains_ckpt.pkl"):
        """Every chain's sampler state and net_state, the step counter and
        the per-chain GMM registries: what a bit-identical resume needs.
        Goes to the DCP directory when `_use_orbax()`, else to `fname`,
        which every process writes whole (through a file of its own,
        renamed into place)."""
        if not self.workdir:
            return None
        if self._use_orbax():
            return self._save_ckpt_orbax(ep)
        states, net_states, _ = self.trainer.all_chains()
        path = os.path.join(self.workdir, fname)
        payload = {
            **self._meta(ep),
            "states": [base.to_host(s) for s in states],
            "net_states": [base.to_host(ns) for ns in net_states],
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)
        self.logger.info("Multi-chain checkpoint saved at %s", path)
        return path

    def _dcp_tree(self):
        """This rank's chains for DCP, keyed by the chain's global index:
        the states (an fsdp shard's vectors as the whole vectors'
        DTensors) and the net_states."""
        tr = self.trainer
        view = (lambda s: s) if tr.shard is None else tr.shard.global_state
        return {"states": {str(c): view(s)
                           for c, s in zip(tr.chains, tr.states)},
                "net_states": {str(c): ns for c, ns in
                               zip(tr.chains, tr.net_states)}}

    def _save_ckpt_orbax(self, ep: int):
        """The chains' states and net_states as the DCP directory
        `<workdir>/chains_ckpt_orbax` (the JAX package's name for its orbax
        directory), their counters included; the rest of `_meta` and the
        counters again in the sidecar `chains_ckpt_orbax.meta.pkl`, which
        rank 0 (or the only process) writes."""
        tr = self.trainer
        path = ckpt.save(os.path.join(self.workdir, "chains_ckpt_orbax"),
                         self._dcp_tree())
        counters = tr.gather_chains([ckpt.host_values(s) for s in tr.states])
        if self.writer:
            meta = {**self._meta(ep), "counters": counters}
            with open(path + ".meta.pkl", "wb") as f:
                pickle.dump(meta, f)
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()
        self.logger.info("Multi-chain DCP checkpoint saved at %s", path)
        return path

    def _load_ckpt_orbax(self, path: str) -> int:
        """Restore a `chains_ckpt_orbax` directory, saved at any layout
        with the same chains, into the chains' own tensors, in place (a
        fused chain's captured graphs then replay on the loaded values);
        the sidecar is read and checked first."""
        tr = self.trainer
        path = os.path.abspath(path)
        with open(path + ".meta.pkl", "rb") as f:
            meta = pickle.load(f)
        self._check_meta(meta)
        tree = self._dcp_tree()
        restored = ckpt.restore(path, tree)
        states = [restored["states"][k] for k in tree["states"]]
        counters = [ckpt.host_values(s) for s in states]
        want = [meta["counters"][c] for c in tr.chains]
        if counters != want:
            raise ValueError(f"{path}: the directory's counters {counters} "
                             f"are not its sidecar's {want}")
        tr.states = states
        tr.net_states = [restored["net_states"][k]
                         for k in tree["net_states"]]
        return self._loaded(meta, path)

    def load_ckpt(self, path: str) -> int:
        """Restore a `chains_ckpt.pkl` or a `chains_ckpt_orbax` directory;
        returns the epoch it was saved at."""
        if os.path.isdir(path):
            return self._load_ckpt_orbax(path)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self._check_meta(payload)
        tr = self.trainer
        tr.states = [tr.local_state(base.from_host(
            tr.states[i], payload["states"][c], self.device))
            for i, c in enumerate(tr.chains)]
        tr.net_states = [base.from_host(tr.net_states[i],
                                        payload["net_states"][c], self.device)
                         for i, c in enumerate(tr.chains)]
        return self._loaded(payload, path)

    # ---- the combined predictive ----------------------------------------------

    @torch.no_grad()
    def evaluate(self, loader):
        """The chains' combined predictive, by method family: the chains x
        cycles GMM mixture once a cycle has completed (cyclical methods);
        the chains' Laplace mixture after stage 2; else each chain's own
        predictive, the chains' samples pooled (for SGLD, SGHMC and
        Adam-SGHMC that is the mixture of the chains' Gaussian moments).
        Returns what BaseRunner.evaluate returns, logits_all [N, C*S, K]."""
        if self._is_cyclical and any(self.chain_cycle_stats):
            return self._gmm_evaluate(loader)
        if self._la_stage2 is not None:
            return self._gaussian_evaluate(loader, *self._la_stage2,
                                           self._la_net_states)
        return self._generic_evaluate(loader)

    def save_logits(self, *args, **kw):
        if self.writer:
            return base.BaseRunner.save_logits(self, *args, **kw)
        return None

    def _gmm_evaluate(self, loader):
        """Within each chain the GMM weights over its cycles, across chains
        equal weights; chain c's component of cycle k draws as a
        single-chain run with the chain's seed draws for cycle k."""
        tr = self.trainer
        _, net_states, seeds = tr.all_chains(states=False)
        comps = []
        for c, w in enumerate(self.gmm_weights_per_chain()):
            for cyc, wv in sorted(w.items()):
                if wv >= 1e-10:
                    st = self.chain_cycle_stats[c][cyc]
                    comps.append((wv / tr.n_chain, st["mean"], st["var"],
                                  net_states[c], seeds[c], cyc))
        return self.runner.mixture_evaluate(loader, comps)

    def _gaussian_evaluate(self, loader, means, vars_, net_states):
        """The mixture of the chains' N(means[c], vars_[c]), each chain
        forwarding with its net_state in `net_states`."""
        r, tr = self.runner, self.trainer

        def pred(x, i):
            return torch.cat([base.gaussian_sample_logits(
                r.target, net_states[c], means[c], vars_[c], x,
                rng.generator(self.device, tr.all_seeds[c], rng.EVAL, 0, i),
                r.nst) for c in range(tr.n_chain)])
        return self._predictive_loop(loader, pred)

    def _generic_evaluate(self, loader):
        """Each chain's `pred_state` and `_predict_logits` under its own
        binding, the chains' samples pooled."""
        r, tr = self.runner, self.trainer
        states, net_states, seeds = tr.all_chains()
        ps = [r.pred_state_from(s, ns) for s, ns in zip(states, net_states)]

        def pred(x, i):
            out = []
            for c in range(tr.n_chain):
                with r.bound(states[c], net_states[c], seeds[c]):
                    out.append(r._predict_logits(ps[c], x, rng.generator(
                        self.device, seeds[c], rng.EVAL, 0, i)))
            return torch.cat(out)
        return self._predictive_loop(loader, pred)
