"""Shared machinery of the cyclical SG-MCMC methods (counterpart of
bayesdll_tpu.methods.cyclical_base):

  * the cyclical cosine step size and phase flags, from the host schedule
    (core/schedule.py) of the global step;
  * per-cycle moments in the sampler state (core/moments.py: Welford for
    cSGHMC, running raw moments for cSGLD), snapshotted to the host at each
    cycle end;
  * the full-train-set likelihood of nst perturbed samples at each cycle
    end;
  * GMM weights w_c = 1 / mean_i(1/p_i), normalised;
  * the mixture predictive: per component the Monte-Carlo averaged log-prob
    vector (raw logits when nst = 0), mixed as a weighted sum on the host;
  * per-cycle checkpoints `{cycle}_ckpt.pkl`;
  * the cycle-boundary hooks: the moments reset (`_reset_cycle_state`) and
    `on_cycle_start(cycle + 1)`, where Adam-cSGHMC and cSGHMC-FS reset
    their sampler state (`_cycle_reset`) and may cold-restart θ, and their
    multi-chain form `multi_chain_cycle_start`; every reset writes the
    state's tensors in place, so a captured graph of the step
    (methods/graphed.py) keeps reading the live state;
  * the fused path's segments, cut after each cycle's last step
    (`segment_ends`), and its per-step lr pair (`lr_pair`);
  * with `full_sample`, every collected θ archived on the host
    (`all_samples`, pickled as `all_samples.pkl` at each completed cycle).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch
from scipy.special import logsumexp

from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.core.schedule import CyclicalSchedule
from bayesdll_tpu_torch.data.stream import window_batches
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.utils import profiling


def gmm_weights_of(cycle_stats: Dict[int, dict]) -> Dict[int, float]:
    """The GMM weight of each cycle with likelihoods in `cycle_stats`,
    w_c = [mean_i 1/p_i]^-1, normalised ({0: 1.0} when there is none)."""
    cycles = [c for c in cycle_stats if "likelihoods" in cycle_stats[c]]
    if not cycles:
        return {0: 1.0}
    weights = {}
    for c in cycles:
        lik = np.maximum(cycle_stats[c]["likelihoods"], 1e-300)
        weights[c] = 1.0 / np.mean(1.0 / lik)
    total = sum(weights.values())
    if total > 0:
        return {c: w / total for c, w in weights.items()}
    return {c: 1.0 / len(weights) for c in weights}


class CyclicalRunnerBase(base.BaseRunner):
    """Runner skeleton for cyclical SG-MCMC methods.  Subclasses provide
    `_step` (consuming the scalars lr, should_sample, collect) and
    `init_state` with a `moments` field (core/moments.py)."""

    # Where the likelihood samples are centred: the live iterate, or the
    # current cycle's Welford mean (the cSGHMC family).
    LIK_CENTER = "iterate"
    # Only the cSGHMC family evaluates a point estimate before the first
    # completed cycle.
    periodic_point_eval = False

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        hp = cfg.hparams
        self.ninflate = float(hp.get("Ninflate", 1.0))
        self.nd = float(hp.get("nd", 1.0))
        self.thin = max(1, int(hp.get("thin", 1)))
        # read by the methods that offer cold restarts (Adam-cSGHMC and
        # cSGHMC-FS, with their `set_reinit_fn`); the others ignore it
        self.cold_restarts = str(hp.get("perform_cold_restarts", "0")) \
            in ("1", "true", "True")
        self._reinit_fn = None
        super().__init__(target, theta_init, net_state, cfg, **kw)
        self.sched: CyclicalSchedule | None = None
        self.current_cycle = 0
        # cycle -> dict(mean, var, n, theta[, likelihoods]) on the host
        self.cycle_stats: Dict[int, dict] = {}
        self.all_samples: Dict[str, np.ndarray] = {}  # the full_sample archive

    # ---- cyclical plumbing --------------------------------------------------

    def _ensure_sched(self, batches_per_epoch: int):
        if self.sched is None:
            self.sched = CyclicalSchedule(
                base_lr=self.cfg.lr,
                num_cycles=self.cfg.num_cycles,
                epochs=self.cfg.epochs,
                batches_per_epoch=batches_per_epoch,
                proportion_exploration=self.cfg.proportion_exploration,
            )

    def train(self, train_loader, val_loader, test_loader, start_epoch=0):
        self._ensure_sched(len(train_loader))
        self._train_loader = train_loader
        return super().train(train_loader, val_loader, test_loader,
                             start_epoch=start_epoch)

    def _should_sample(self, step: int) -> bool:
        """One flag gates both sample collection and the noise: the
        exploitation phase AND the within-epoch thinning stride."""
        s = self.sched
        return s.should_sample_py(step) and \
            ((step % s.batches_per_epoch) % self.thin == 0)

    def step_scalars(self, ep: int) -> dict:
        should_sample = self._should_sample(self.bi)
        return {"lr": self.sched.lr_py(self.bi), "should_sample": should_sample,
                "collect": should_sample}

    def lr_pair(self, lr_t: float):
        """(body, head) lr of a step as fp32: lr_t, and lr_t * lr_head/lr,
        rounded as the JAX package rounds them."""
        lr32 = np.float32(lr_t)
        return lr32, lr32 * np.float32(self.cfg.lr_head / self.cfg.lr)

    def cyclical_lr_vec(self, lr_t) -> torch.Tensor:
        """Per-element lr [dim]: the body lr for the body, the head lr for
        the head (`lr_pair`).  On the per-step path lr_t is the host's
        float, and both values enter as kernel arguments, so no
        host-to-device copy waits; on the fused path it is the pair itself,
        as 0-d tensors on the device."""
        with profiling.span("lr_vec"):
            if isinstance(lr_t, tuple):
                body, head = lr_t
                return torch.where(self.target.is_head, head, body)
            body, head = self.lr_pair(lr_t)
            return torch.where(self.target.is_head, float(head), float(body))

    def segment_ends(self, ep: int, n_steps: int):
        """The fused path's cuts: after each step of the epoch that ends a
        cycle, so that the cycle-end work runs at its step."""
        return [i + 1 for i in range(n_steps)
                if self.sched.last_in_cycle_py(self.bi + i)]

    def after_batch(self, ep: int):
        step = self.bi - 1  # the step that just ran
        if self.cfg.full_sample and self._should_sample(step):
            bpe = self.sched.batches_per_epoch
            self.collect_full_sample(step // bpe, step % bpe)
        if self.sched.last_in_cycle_py(step):
            self._end_of_cycle(self.sched.cycle_number_py(step))

    def collect_full_sample(self, ep: int, batch_idx: int):
        """The full_sample archive: a host copy of θ under "{ep}_{batch}"."""
        self.all_samples[f"{ep}_{batch_idx}"] = base.to_host(self.state.theta)

    def eval_ready(self, ep: int) -> bool:
        # the GMM predictive needs one completed cycle; before that the
        # point estimate is evaluated where the method asks for it
        if self.cycle_stats:
            return True
        return self.periodic_point_eval and (
            ep % 5 == 0 or ep == self.cfg.epochs - 1)

    # ---- cycle boundary (host) ---------------------------------------------

    @staticmethod
    def _moments_count(state) -> int:
        """Collected samples: RunningMoments counts in `cnt`, the Welford
        moments in `n`."""
        m = state.moments
        return getattr(m, "cnt", getattr(m, "n", 0))

    def _end_of_cycle(self, cycle: int):
        with profiling.span("cycle_end", cycle):
            self._cycle_end_work(cycle)

    def _cycle_end_work(self, cycle: int):
        state = self.state
        with profiling.span("cycle_end.snapshot"):
            mean, var = state.moments.mean_var()
            n = self._moments_count(state)
            self.cycle_stats[cycle] = {
                "mean": base.to_host(mean, "cycle_end"),
                "var": base.to_host(var, "cycle_end"),
                "n": n,
                "theta": base.to_host(state.theta, "cycle_end"),
            }
        if cycle > self.current_cycle:
            self.current_cycle = cycle
            self.logger.info("Completed cycle %d (samples collected: %d)",
                             cycle, n)
            with profiling.span("cycle_end.likelihoods"):
                lik = self.full_batch_likelihoods(self._train_loader)
            self.cycle_stats[cycle]["likelihoods"] = lik
            self.logger.info("Cycle %d full batch likelihood: %.6e",
                             cycle, float(np.mean(lik)))
            with profiling.span("cycle_end.ckpt"):
                self.save_ckpt(cycle, fname=f"{cycle}_ckpt.pkl")
                if self.cfg.full_sample and self.workdir:
                    with open(os.path.join(self.workdir, "all_samples.pkl"),
                              "wb") as f:
                        pickle.dump(self.all_samples, f)
        self.state = self._reset_cycle_state(self.state)
        self.on_cycle_start(cycle + 1)

    def _reset_cycle_state(self, state):
        """The state with empty moments for the next cycle, cleared in
        place."""
        state.moments.clear()
        return state

    def on_cycle_start(self, cycle: int):
        """Entering `cycle` (1-based): `_cycle_reset` of the state, with a
        cold-restart θ where the method offers one."""
        self._cycle_reset(self.state, self._cold_restart_theta(cycle))

    def multi_chain_cycle_start(self, trainer, cycle: int):
        """on_cycle_start for every chain of a multi-chain trainer (its
        `states`, the rank's own), each cold restart drawn from the chain's
        own seed, as the rank holds it (`local_vector`)."""
        thetas = self._multi_chain_restart_thetas(trainer, cycle)
        for c, state in enumerate(trainer.states):
            self._cycle_reset(state, None if thetas is None
                              else trainer.local_vector(thetas[c]))

    def _cycle_reset(self, state, theta):
        """The per-cycle reset of `state` (in place), θ replaced by `theta`
        unless it is None.  cSGLD and cSGHMC carry their sampler state
        across cycles; Adam-cSGHMC and cSGHMC-FS override."""

    def _restart_allowed(self, cycle: int) -> bool:
        """The cold-restart gate, `cycle` the cycle being entered.  The
        reference guards with `cycle_number >= 1` and the comment 'Don't
        restart after cycle 0' (`methods/csghmc_fs.py:594`,
        `methods/adam_csghmc.py:408`), but its `get_cycle_number` is 1-based
        (`(k-1)//cycle_length + 1`, `methods/cyclical.py:69-74`), so at the
        first boundary cycle_number is 1 and the guard always holds: the
        reference restarts at every cycle boundary, after the first and
        after the final cycle too (the restart sits inside `cycle_number >
        self.current_cycle`, which the final boundary also passes).  The JAX
        package reproduces that trace, and so does the port."""
        return True

    def _restarts_on(self, cycle: int) -> bool:
        return self.cold_restarts and self._reinit_fn is not None \
            and self._restart_allowed(cycle)

    def _cold_restart_theta(self, cycle: int):
        """A fresh θ for `cycle` from the re-init function, or None when cold
        restarts are off or no function is set."""
        if not self._restarts_on(cycle):
            return None
        self.logger.info("Cold restart: network re-initialised for cycle %d",
                         cycle)
        return self._reinit_fn(cycle).to(self.device, torch.float32)

    def _multi_chain_restart_thetas(self, trainer, cycle: int):
        """Fresh θ for each chain of `trainer`, the re-init function keyed
        by the chain's seed, or None as for `_cold_restart_theta`."""
        if not self._restarts_on(cycle):
            return None
        self.logger.info("Cold restart: %d chains re-initialised for cycle %d",
                         trainer.n_chain, cycle)
        return [self._reinit_fn(cycle, seed=s).to(self.device, torch.float32)
                for s in trainer.seeds]

    # ---- full-batch likelihoods --------------------------------------------

    def full_batch_likelihoods(self, train_loader) -> np.ndarray:
        """likelihood_s = exp(-mean CE over the train set) for nst samples
        perturbed around LIK_CENTER with the current cycle's variance."""
        return self.chains_likelihoods(
            train_loader, [(self.state, self.net_state, self.seed)])[0]

    @torch.no_grad()
    def chains_likelihoods(self, train_loader, chains):
        """full_batch_likelihoods of each (state, net_state, seed) in
        `chains`, in one pass over the loader, so that every chain sees the
        same examples.

        The pass runs in windows of stacked batches; within a window every
        sample's CE accumulates.  Sample s of a chain is regenerated in each
        window from the generator keyed (seed, LIKELIHOOD, s), so it is the
        same sample in every window."""
        self.logger.info(
            "Calculating full-batch likelihood for current cycle using %d "
            "samples...", max(1, self.nst))
        nst = max(1, self.nst)
        setups = []
        for state, ns, seed in chains:
            mean, var = state.moments.mean_var()
            n = self._moments_count(state)
            # a cycle that collected nothing has an all-zero mean: centre on
            # the live iterate instead
            center = state.theta if (self.LIK_CENTER == "iterate" or n == 0) \
                else mean
            std = torch.sqrt(var) if (self.nst > 0 and n > 1) else None
            setups.append((center, std, ns, seed))

        tot = np.zeros((len(chains), nst))
        cnt = 0.0
        for xs, ys, vs in window_batches(train_loader):
            xs_d = self._to_device(xs, "batch")
            ys_d = self._to_device(ys, "batch").long()
            vs_d = self._to_device(vs, "batch")
            for k, (center, std, ns, seed) in enumerate(setups):
                for s in range(nst):
                    theta_s = center
                    if std is not None:
                        gen = rng.generator(self.device, seed,
                                            rng.LIKELIHOOD, s)
                        theta_s = center + std * torch.randn(
                            center.shape, generator=gen, device=self.device)
                    acc = torch.zeros((), device=self.device)
                    for b in range(xs_d.shape[0]):
                        logits, _ = self.target.forward(theta_s, ns, xs_d[b],
                                                        train=False)
                        picked = torch.log_softmax(logits, -1).gather(
                            1, ys_d[b][:, None])[:, 0]
                        acc += torch.sum(-picked * vs_d[b])
                    profiling.host_sync("likelihoods")
                    tot[k, s] += float(acc)
            cnt += float(vs.sum())
        return list(np.exp(-tot / cnt))

    # ---- GMM predictive -----------------------------------------------------

    def gmm_weights(self) -> Dict[int, float]:
        """w_c = [mean_i 1/p_i]^-1, normalised."""
        return gmm_weights_of(self.cycle_stats)

    def pred_state(self):
        return self.state.theta

    def _predict_logits(self, theta, x, generator):
        return self.target.forward(theta, self.net_state, x, train=False)[0][None]

    @torch.no_grad()
    def evaluate(self, loader):
        """GMM mixture predictive; before the first completed cycle, the
        point estimate at the current iterate.  Component c of batch i draws
        from the generator keyed (seed, EVAL, c, i)."""
        if not any("likelihoods" in v for v in self.cycle_stats.values()):
            return self._point_evaluate(loader)
        comps = [(w, self.cycle_stats[c]["mean"], self.cycle_stats[c]["var"],
                  self.net_state, self.seed, c)
                 for c, w in sorted(self.gmm_weights().items()) if w >= 1e-10]
        return self.mixture_evaluate(loader, comps)

    @torch.no_grad()
    def mixture_evaluate(self, loader, comps):
        """The mixture of Gaussian components `comps`, a list of (weight,
        mean, var, net_state, seed, comp_id) with mean and var on the host:
        per component the Monte-Carlo averaged log-probs (raw logits when
        nst = 0), summed with the weights on the host.  The component's
        batch i draws from the generator keyed (seed, EVAL, comp_id, i)."""
        p = next(base.PASS_IDS)
        with profiling.span("predict.pass", p):
            with profiling.span("predict.upload"):
                moments = [(self._to_device(mean, "component"),
                            self._to_device(var, "component"))
                           for _, mean, var, *_ in comps]
            loss_sum, err_sum, n = 0.0, 0.0, 0.0
            targets, logits_list, logits_all_list = [], [], []
            for i, (x, y, valid) in enumerate(loader):
                with profiling.span("predict.batch", (p, i)):
                    xd = self._to_device(x, "batch")
                    mix = None
                    comp_stack = []
                    for (w, _, _, ns, seed, cid), (mean, var) in zip(
                            comps, moments):
                        gen = rng.generator(self.device, seed, rng.EVAL, cid,
                                            i)
                        la = base.gaussian_sample_logits(
                            self.target, ns, mean, var, xd, gen,
                            self.nst)  # [S, B, K]
                        comp_out = la[0] if self.nst == 0 \
                            else base.combine_mc_logits(la)
                        with profiling.span("predict.readback"):
                            profiling.host_sync("predict", 2)
                            comp_out = comp_out.cpu().numpy()
                            comp_stack.append(
                                la.cpu().numpy().transpose(1, 0, 2))
                        with profiling.span("predict.mix"):
                            mix = w * comp_out if mix is None \
                                else mix + w * comp_out
                    with profiling.span("predict.mix"):
                        logp = mix - logsumexp(mix, axis=-1, keepdims=True)
                        picked = logp[np.arange(len(y)), y]
                        loss_sum += float(np.sum(-picked * valid))
                        err_sum += float(np.sum((np.argmax(mix, -1) != y)
                                                * valid))
                        nv = int(valid.sum())
                        n += nv
                        targets.append(y[:nv])
                        logits_list.append(mix[:nv])
                        logits_all_list.append(
                            np.concatenate(comp_stack, axis=1)[:nv])
        return (loss_sum / n, err_sum / n, np.concatenate(targets),
                np.concatenate(logits_list), np.concatenate(logits_all_list))

    @torch.no_grad()
    def _point_evaluate(self, loader):
        """Point-estimate evaluation at the current iterate."""
        theta = self.state.theta
        p = next(base.PASS_IDS)
        with profiling.span("predict.pass", p):
            loss_sum = torch.zeros((), device=self.device)
            err_sum = torch.zeros((), device=self.device)
            n = 0.0
            targets, logits_list, logits_all_list = [], [], []
            for i, (x, y, valid) in enumerate(loader):
                with profiling.span("predict.batch", (p, i)):
                    yd = self._to_device(y, "batch").long()
                    vd = self._to_device(valid, "batch")
                    logits, _ = self.target.forward(
                        theta, self.net_state, self._to_device(x, "batch"),
                        train=False)
                    picked = torch.log_softmax(logits, -1).gather(
                        1, yd[:, None])[:, 0]
                    loss_sum += torch.sum(-picked * vd)
                    err_sum += torch.sum(
                        (torch.argmax(logits, -1) != yd).float() * vd)
                    nv = int(valid.sum())
                    n += nv
                    with profiling.span("predict.readback"):
                        profiling.host_sync("predict")
                        lp = logits[:nv].cpu().numpy()
                    targets.append(y[:nv])
                    logits_list.append(lp)
                    logits_all_list.append(lp[:, None, :])
            with profiling.span("predict.readback"):
                profiling.host_sync("predict", 2)
                loss, err = float(loss_sum) / n, float(err_sum) / n
        return (loss, err, np.concatenate(targets),
                np.concatenate(logits_list), np.concatenate(logits_all_list))

    def extra_ckpt(self):
        return {
            "current_cycle": self.current_cycle,
            "cycle_stats": self.cycle_stats,
            "thin": self.thin,
            "nst": self.nst,
        }
