"""Shared runner skeleton and predictive helpers (counterpart of
bayesdll_tpu.methods.base).

A method subclass provides:
  * `init_state(theta_init)`               -> sampler state
  * `_step(state, ns, x, y, step, sc)`     -> (state', ns', (loss, err_count))
  * `pred_state()` and `_predict_logits(ps, x, generator)` -> [S, B, K]
plus host hooks (`eval_ready`, `step_scalars`, `epoch_begin`,
`after_batch`).  `step` is the global step index: with the runner's
`seed` (the run's seed, or one chain's in a multi-chain run) it keys every
random draw of that step.

For the multi-chain trainer (parallel/chains.py), `iterate`/`with_iterate`
name the primary vector of a state (θ, or the variational mean), and
`bound` runs the runner on one chain's state, net_state and seed.  On a
rank that holds a shard of a chain's flat vectors (fsdp, tensor
parallelism: parallel/shard.py), `shard` is that shard while the step runs:
`draw_args` then places the kernels' and the draws' noise at the shard's
global offset, and `shard_sum` sums a per-element loss term over the
ranks.

Per-step loss and error stay on the device; the host reads them once per
epoch, so the training loop never waits on the card.

The fused path (`cfg.fused_steps`; counterpart of the JAX package's
`use_fused`, `segment_ends`, `_train_one_epoch_fused`, `after_segment`,
`_fused_key` and `run_steps`): an epoch runs in segments cut at the
method's host-work steps (cycle ends) and at a 256 MiB window of stacked
batches, as the JAX package cuts them; each segment is `run_steps`, which
on the card replays one captured CUDA graph of `_step` per step
(methods/graphed.py).  There `_step` gets `step=None` and the fused
scalars (`graphed.fused_scalars`: the kernels' `dev` (seed, step, gate),
the lr pair, `collect`, Adam's bias corrections `bc` and the moments'
`count`, all tensors on the device), which `draw_args` and
`collect_sample` turn into the kernels', the draws' and the moments'
device forms.  It serves all eleven methods.

Predictive combination shared by the stochastic methods:
  logits = logsumexp(log_softmax(logits_all), sample_dim) - log(S)
the log of the Monte-Carlo averaged predictive probabilities.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import logging
import math
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bayesdll_tpu_torch.core import rng
from bayesdll_tpu_torch.data.loader import ArrayLoader
from bayesdll_tpu_torch.methods import graphed
from bayesdll_tpu_torch.ops import kernels
from bayesdll_tpu_torch.utils import calibration, profiling

_LOG = logging.getLogger("bayesdll_tpu_torch")
# the ids of the process's predictive passes, for their spans
PASS_IDS = itertools.count()


def combine_mc_logits(logits_all: torch.Tensor) -> torch.Tensor:
    """[S, B, K] -> [B, K] Monte-Carlo averaged predictive log-probs."""
    s = logits_all.shape[0]
    return torch.logsumexp(torch.log_softmax(logits_all, dim=-1), dim=0) - math.log(s)


def ce_loss(logits, y):
    """Mean cross-entropy."""
    return F.cross_entropy(logits, y.long())


def err_count(logits, y):
    return torch.sum(torch.argmax(logits, dim=-1) != y)


def gaussian_sample_logits(target, net_state, mean, var, x, generator, nst: int):
    """Predictive under theta ~ N(mean, var): [S, B, K] logits.

    nst == 0 is a single forward at the mean.  Samples run one after
    another, so memory stays at one parameter vector whatever nst is.
    """
    if nst == 0:
        return target.forward(mean, net_state, x, train=False)[0][None]
    with profiling.span("predict.draw"):
        std = torch.sqrt(var)
    out = []
    for _ in range(nst):
        with profiling.span("predict.draw"):
            eps = torch.randn(mean.shape, generator=generator,
                              dtype=mean.dtype, device=mean.device)
            theta = mean + std * eps
        out.append(target.forward(theta, net_state, x, train=False)[0])
    return torch.stack(out)


def to_host(obj, site: str = "other"):
    """A copy of `obj` with every tensor as a numpy array (dataclasses become
    dicts), for pickling; each tensor read is a host sync at `site`."""
    if isinstance(obj, torch.Tensor):
        profiling.host_sync(site)
        return obj.detach().to("cpu", copy=True).numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_host(getattr(obj, f.name), site)
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_host(v, site) for k, v in obj.items()}
    return obj


def from_host(template, saved, device):
    """Inverse of to_host: `template`'s structure filled from `saved`."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(saved).to(device)
    if isinstance(template, int):  # counts saved as numpy scalars
        return int(saved)
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: from_host(getattr(template, f.name), saved[f.name], device)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: from_host(v, saved[k], device) for k, v in template.items()}
    return saved


class BaseRunner:
    method_name = "base"
    FUSED_BYTES_BUDGET = 256 * 1024 * 1024  # max stacked batch bytes/segment
    shard = None  # the step's parallel/shard.FlatShard, or None
    writer = True  # writes the plots (one rank of a multi-process run)

    def __init__(self, target, theta_init, net_state, cfg, logger=None,
                 workdir: Optional[str] = None):
        self.target = target
        self.device = target.device
        self.net_state = dict(net_state or {})
        self.cfg = cfg
        self.logger = logger or _LOG
        self.workdir = workdir
        if workdir:
            os.makedirs(workdir, exist_ok=True)

        self.prior_sig = cfg.hp("prior_sig", 1.0, float) \
            if "prior_sig" in cfg.hparams else 1.0
        self.bias_mode = cfg.hparams.get("bias", "informative")
        self.nst = int(cfg.hparams.get("nst", 0))
        self.seed = cfg.seed  # keys every draw; a chain's own in `bound`

        self.state = self.init_state(
            torch.as_tensor(theta_init, dtype=torch.float32)
            .to(self.device, copy=True))
        self.bi = 0  # global step counter
        self._step_graphs = {}  # the runner's or a chain's seed -> StepGraph
        self.results = {}
        self._train_step_count = 0
        self._train_step_time = 0.0

    # ---- subclass interface -------------------------------------------------

    def init_state(self, theta_init):
        raise NotImplementedError

    def _step(self, state, ns, x, y, step, scalars):
        raise NotImplementedError

    def pred_state(self):
        raise NotImplementedError

    def _predict_logits(self, pred_state, x, generator):
        raise NotImplementedError

    def eval_ready(self, ep: int) -> bool:
        return True

    # ---- multi-chain hooks --------------------------------------------------

    def iterate(self, state) -> torch.Tensor:
        """The primary vector of `state`, which a chain's initial jitter
        moves: θ (the variational mean for VI and MC-dropout)."""
        return state.theta

    def with_iterate(self, state, vec: torch.Tensor):
        return dataclasses.replace(state, theta=vec)

    @contextlib.contextmanager
    def bound(self, state, net_state, seed: int):
        """The runner on one chain: `state`, `net_state` and `seed` stand in
        for its own inside the block (so `_step`, `pred_state`, the hooks
        and every draw read them), and are put back after.  The block reads
        what the runner leaves in self.state and self.net_state before it
        ends."""
        saved = self.state, self.net_state, self.seed
        self.state, self.net_state, self.seed = state, net_state, seed
        try:
            yield self
        finally:
            self.state, self.net_state, self.seed = saved

    def pred_state_from(self, state, net_state):
        """`pred_state()` of another state (one chain's)."""
        with self.bound(state, net_state, self.seed):
            return self.pred_state()

    def step_scalars(self, ep: int) -> dict:
        """Host scalars of the step at self.bi (lr, collect flag, ...)."""
        return {}

    def epoch_begin(self, ep: int):
        pass

    def after_batch(self, ep: int):
        """Host hook after each step (cycle boundaries etc.)."""

    def extra_ckpt(self) -> dict:
        return {}

    # ---- training -----------------------------------------------------------

    def _to_device(self, a, site: str = "other") -> torch.Tensor:
        """Host batch -> device.  To a card the copy goes from pinned memory
        and does not block, so the host never waits for the card's queue.
        The recorder counts the bytes handed over (`to_device_bytes`) and
        those pinned anew (`pinned_bytes`) at `site`: batch, component or
        other."""
        with profiling.span("to_device"):
            t = torch.as_tensor(a)
            to_card = self.device.type == "cuda" and t.device.type == "cpu"
            if profiling.recording():
                profiling.count("to_device_bytes", t.nbytes, site)
                if to_card and not t.is_pinned():
                    profiling.count("pinned_bytes", t.nbytes, site)
            if to_card:
                return t.pin_memory().to(self.device, non_blocking=True)
            return t.to(self.device)

    def _one_step(self, ep: int, x, y):
        with profiling.span("step", self.bi):
            scalars = self.step_scalars(ep)
            self.state, self.net_state, metrics = self._step(
                self.state, self.net_state, self._to_device(x, "batch"),
                self._to_device(y, "batch"), self.bi, scalars)
            self.bi += 1
        return metrics

    def step_loop(self, ep: int, xs, ys, bi0: int):
        """len(xs) per-step steps from global step bi0, one `_one_step`
        each, with no host hooks in between.  xs: [K, B, ...], ys: [K, B].
        Returns stacked (loss[K], err[K]) on the device."""
        self.bi = bi0
        metrics = [self._one_step(ep, xs[k], ys[k]) for k in range(len(xs))]
        return (torch.stack([m[0] for m in metrics]),
                torch.stack([m[1] for m in metrics]))

    # ---- the fused path ---------------------------------------------------

    def draw_args(self, step, scalars) -> dict:
        """The draw arguments of a sampler kernel or of `fused.draw_`: the
        host's seed and step on the per-step path, the device row `dev`
        (seed, step, gate) on the fused path."""
        args = {"dev": scalars["dev"]} if "dev" in scalars else \
            {"seed": self.seed, "step": step}
        if self.shard is not None and self.shard.sharded:
            args.update(elem0=self.shard.elem0, total=self.shard.total)
        return args

    def shard_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A sum over the flat vector's elements, `t` the sum over this
        rank's part of them: the whole sum on a sharded rank, `t` else."""
        return t if self.shard is None else self.shard.sum(t)

    @staticmethod
    def collect_sample(state, scalars):
        """A step's moments update: on the per-step path a branch on the
        host's `collect`; on the fused path the masked update, which reads
        nothing on the host, in the graph of the collecting steps (the
        other graph's scalars have `collect` None)."""
        if "dev" not in scalars:
            if scalars["collect"]:
                with profiling.span("moments"):
                    state.moments.update(state.theta)
        elif scalars["collect"] is not None:
            with profiling.span("moments"):
                state.moments.update_masked(state.theta, scalars["collect"],
                                            scalars["count"])

    def _fused_key(self, ep: int):
        """What the captured step depends on beyond the state's addresses:
        epochs with the same key share one graph (the JAX package's cache
        key of its scanned program)."""
        return 0

    def use_fused(self, ep: int) -> bool:
        """Whether epoch ep runs the fused path.  With full_sample the epoch
        runs per step, as in the JAX package: each collecting step copies θ
        to the host."""
        if not getattr(self.cfg, "fused_steps", False):
            return False
        if self.cfg.full_sample:
            self.logger.info("fused_steps: full_sample collects on the host "
                             "after each step, so epoch %d runs per step", ep)
            return False
        return True

    def segment_ends(self, ep: int, n_steps: int):
        """Step indices (exclusive, within the epoch) after which host work
        must run: none by default."""
        return []

    def after_segment(self, ep: int):
        """Host work at a segment's end: what after_batch does at its step."""
        self.after_batch(ep)

    def bias_corrections(self, k: int) -> np.ndarray:
        """Adam's bias corrections (1 - b1^t, 1 - b2^t) of the next k steps
        of the state, [k, 2] fp32: 1 where the method has no Adam."""
        return np.ones((k, 2), np.float32)

    def fused_rows(self, ep: int, bi0: int, k: int):
        """The scalars of the k steps from global step bi0, computed on the
        host by `step_scalars` and `bias_corrections` (the counterpart of
        the JAX package's `device_scalars`): int64 rows (seed, step, gate)
        for the kernels and the draws, and fp32 rows (lr_body, lr_head,
        collect, bc1, bc2), lr 0 where the method has no schedule."""
        ints = np.zeros((k, kernels.DEV_SCALARS), np.int64)
        flts = np.zeros((k, graphed.FLOAT_COLUMNS), np.float32)
        seed = kernels.seed_int64(self.seed)
        saved = self.bi
        try:
            for j in range(k):
                self.bi = bi0 + j
                sc = self.step_scalars(ep)
                ints[j] = (seed, bi0 + j, bool(sc.get("should_sample", False)))
                if "lr" in sc:
                    flts[j, :2] = self.lr_pair(sc["lr"])
                flts[j, 2] = bool(sc.get("collect", False))
        finally:
            self.bi = saved
        flts[:, 3:] = self.bias_corrections(k)
        return ints, flts

    def run_steps(self, ep: int, xs, ys, bi0: int):
        """len(xs) consecutive train steps from global step bi0 with no host
        hooks in between, fused (methods/graphed.py): on the card, replays
        of the step's CUDA graph, captured for this runner (or chain) and
        its state's addresses.  xs: [K, B, ...], ys: [K, B] (numpy, or
        tensors).  Returns (loss[K], err[K]) on the device."""
        graph = self._step_graphs.get(self.seed)
        if graph is None:
            graph = self._step_graphs[self.seed] = graphed.StepGraph()
        with profiling.span("fused.segment"):
            return graph.run(self, ep, xs, ys, bi0)

    def train(self, train_loader, val_loader, test_loader, start_epoch=0):
        """Epoch loop with eval cadence and best-checkpoint artifacts."""
        cfg, logger = self.cfg, self.logger
        logger.info("Start training...")
        losses_train = np.zeros(cfg.epochs)
        errors_train = np.zeros(cfg.epochs)
        best_loss = np.inf
        tic0 = time.time()
        self._train_step_count = 0
        self._train_step_time = 0.0
        for ep in range(start_epoch, cfg.epochs):
            self.epoch_begin(ep)
            tic = time.time()
            losses_train[ep], errors_train[ep] = self.train_one_epoch(ep, train_loader)
            toc = time.time()
            self._train_step_count += len(train_loader)
            self._train_step_time += toc - tic
            logger.info(
                "[Epoch %d/%d] Training summary: loss = %.4f, "
                "prediction error = %.4f (time: %.4f seconds)",
                ep, cfg.epochs, losses_train[ep], errors_train[ep], toc - tic)
            if ep % cfg.test_eval_freq == 0 and self.eval_ready(ep):
                best_loss = self._eval_and_maybe_save(
                    ep, val_loader, test_loader, best_loss)
        toc0 = time.time()
        logger.info(
            "Training done! Total time = %f (average per epoch = %f) seconds",
            toc0 - tic0, (toc0 - tic0) / max(cfg.epochs, 1))
        self.results.setdefault("best_loss", float(best_loss))
        self.results["total_time"] = toc0 - tic0
        self.results["train_losses"] = losses_train.tolist()
        self.results["train_errors"] = errors_train.tolist()
        if self._train_step_time > 0:
            sps = self._train_step_count / self._train_step_time
            self.results["train_steps_per_sec"] = sps
            self.results["grad_evals_per_sec"] = sps * cfg.batch_size
            logger.info("Throughput: %.1f steps/s = %.0f gradient-evals/s",
                        sps, sps * cfg.batch_size)
        return self.results

    def train_one_epoch(self, ep: int, train_loader):
        with profiling.span("epoch", ep):
            if self.use_fused(ep):
                return self._train_one_epoch_fused(ep, train_loader)
            losses, errs, nb = [], [], 0
            bs = train_loader.batch_size
            # an in-memory set is gathered on the device (ArrayLoader.
            # batches_on): the batches reach _to_device there already
            batches = train_loader.batches_on(self.device) \
                if isinstance(train_loader, ArrayLoader) else train_loader
            for x, y, _valid in batches:
                loss, err = self._one_step(ep, x, y)
                losses.append(loss)
                errs.append(err)
                nb += bs
                with profiling.span("after_batch"):
                    self.after_batch(ep)
            return self._epoch_read(torch.stack(losses), torch.stack(errs),
                                    bs, nb)

    @staticmethod
    def _epoch_read(losses, errs, bs: int, nb: int):
        """The one host read of the epoch: (mean loss, error rate) of the
        per-step device values."""
        with profiling.span("epoch.read"):
            profiling.host_sync("epoch", 2)
            return float(losses.sum()) * bs / nb, float(errs.sum()) / nb

    def _train_one_epoch_fused(self, ep: int, train_loader):
        """The epoch in fused segments (JAX `_train_one_epoch_fused`): cut
        after each of `segment_ends` and when the stacked batches reach
        FUSED_BYTES_BUDGET, with `after_segment` at each segment end.  The
        batches stream through one segment's buffer; an in-memory set is
        gathered on the device, as in train_one_epoch.  The epoch's loss
        and error reduce the per-step values as train_one_epoch does."""
        n = len(train_loader)
        bs = train_loader.batch_size
        losses, errs = [], []
        batches = train_loader.batches_on(self.device) \
            if isinstance(train_loader, ArrayLoader) else train_loader
        for xs, ys, at_end in graphed.segments(
                ((x, y) for x, y, _ in batches), n,
                self.segment_ends(ep, n), self.FUSED_BYTES_BUDGET):
            loss_k, err_k = self.run_steps(ep, xs, ys, self.bi)
            losses.append(loss_k)
            errs.append(err_k)
            if at_end:
                with profiling.span("after_batch"):
                    self.after_segment(ep)
        return self._epoch_read(torch.cat(losses), torch.cat(errs), bs,
                                n * bs)

    # ---- evaluation ---------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, loader):
        """Monte-Carlo predictive evaluation.  Batch i draws from a generator
        keyed by (seed, EVAL, 0, i).

        Returns (loss, err, targets, logits, logits_all), logits_all [N, S, K].
        """
        ps = self.pred_state()
        return self._predictive_loop(loader, lambda x, i: self._predict_logits(
            ps, x, rng.generator(self.device, self.seed, rng.EVAL, 0, i)))

    def _predictive_loop(self, loader, pred_fn):
        """The eval loop over `loader`: pred_fn(x, i) gives batch i's
        logits_all [S, B, K] for x on the device; its Monte-Carlo average
        gives the metrics and the artifacts."""
        p = next(PASS_IDS)
        with profiling.span("predict.pass", p):
            loss_sum = torch.zeros((), device=self.device)
            err_sum = torch.zeros((), device=self.device)
            n = 0.0
            targets, logits_list, logits_all_list = [], [], []
            for i, (x, y, valid) in enumerate(loader):
                with profiling.span("predict.batch", (p, i)):
                    yd = self._to_device(y, "batch").long()
                    vd = self._to_device(valid, "batch")
                    la = pred_fn(self._to_device(x, "batch"), i)
                    logits = combine_mc_logits(la)
                    picked = torch.log_softmax(logits, -1).gather(
                        1, yd[:, None])[:, 0]
                    loss_sum += torch.sum(-picked * vd)
                    err_sum += torch.sum(
                        (torch.argmax(logits, -1) != yd).float() * vd)
                    nv = int(valid.sum())
                    n += nv
                    targets.append(y[:nv])
                    with profiling.span("predict.readback"):
                        profiling.host_sync("predict", 2)
                        logits_list.append(logits[:nv].cpu().numpy())
                        logits_all_list.append(
                            la.transpose(0, 1)[:nv].cpu().numpy())
            with profiling.span("predict.readback"):
                profiling.host_sync("predict", 2)
                loss, err = float(loss_sum) / n, float(err_sum) / n
        return (loss, err, np.concatenate(targets),
                np.concatenate(logits_list), np.concatenate(logits_all_list))


    def _eval_and_maybe_save(self, ep, val_loader, test_loader, best_loss):
        logger = self.logger
        val_pack = None
        if val_loader is not None:
            tic = time.time()
            val_pack = self.evaluate(val_loader)
            logger.info(
                "(Epoch %d) Validation summary: loss = %.4f, prediction "
                "error = %.4f (time: %.4f seconds)",
                ep, val_pack[0], val_pack[1], time.time() - tic)
        tic = time.time()
        test_pack = self.evaluate(test_loader)
        logger.info(
            "(Epoch %d) Test summary: loss = %.4f, prediction error = %.4f "
            "(time: %.4f seconds)",
            ep, test_pack[0], test_pack[1], time.time() - tic)

        loss_now = val_pack[0] if val_pack is not None else test_pack[0]
        if loss_now < best_loss:
            best_loss = loss_now
            logger.info("Best evaluation loss so far! @epoch %d: loss = %s",
                        ep, loss_now)
            self.results.update(
                best_epoch=ep,
                best_loss=float(loss_now),
                test_loss=float(test_pack[0]),
                test_err=float(test_pack[1]),
            )
            if val_pack is not None:
                self.save_logits(*val_pack[2:], suffix="val")
            self.save_logits(*test_pack[2:], suffix="test")
            self.save_ckpt(ep)
            self._calibrate(val_pack, test_pack)
        return best_loss

    def _calibrate(self, val_pack, test_pack):
        cfg, logger = self.cfg, self.logger
        targets_test, logits_test = test_pack[2], test_pack[3]
        # plots go to the workdir where matplotlib is installed; the other
        # artifacts do not need it
        plot_dir = self.workdir if self.writer and calibration.can_plot() \
            else None
        plot = os.path.join(plot_dir, "reliability_T1.png") \
            if plot_dir else None
        ece, mce, nll = calibration.analyze(
            targets_test, logits_test, num_bins=cfg.ece_num_bins,
            plot_save_path=plot, temperature=1)
        logger.info("[Calibration - Default T=1] ECE = %.4f, MCE = %.4f, "
                    "NLL = %.4f", ece, mce, nll)
        self.results.update(ece=ece, mce=mce, nll=nll)
        if val_pack is None:
            return
        curve = os.path.join(plot_dir, "temp_scale_optim_curve.png") \
            if plot_dir else None
        topt, success = calibration.find_optimal_temperature(
            val_pack[2], val_pack[3], plot_save_path=curve)
        if not success:
            logger.info("!! Temperature scaling optimization failed !!")
            return
        plot2 = os.path.join(plot_dir, "reliability_Topt.png") \
            if plot_dir else None
        ece_ts, mce_ts, nll_ts = calibration.analyze(
            targets_test, logits_test, num_bins=cfg.ece_num_bins,
            plot_save_path=plot2, temperature=topt)
        logger.info("[Calibration - Temp-scaled Topt=%.4f] ECE = %.4f, "
                    "MCE = %.4f, NLL = %.4f", topt, ece_ts, mce_ts, nll_ts)
        self.results.update(topt=topt, ece_ts=ece_ts, mce_ts=mce_ts,
                            nll_ts=nll_ts)

    # ---- artifacts ----------------------------------------------------------

    def save_logits(self, targets, logits, logits_all, suffix="test"):
        if not self.workdir:
            return None
        fname = os.path.join(self.workdir, f"logits_{suffix}.pkl")
        with open(fname, "wb") as f:
            pickle.dump({"targets": targets, "logits": logits,
                         "logits_all": logits_all}, f)
        self.logger.info("Logits on %s set saved at %s", suffix, fname)
        return fname

    def save_ckpt(self, ep: int, fname: str = "ckpt.pkl"):
        if not self.workdir:
            return None
        path = os.path.join(self.workdir, fname)
        payload = {
            "epoch": ep,
            "bi": self.bi,
            "method": self.method_name,
            "prior_sig": self.prior_sig,
            "state": to_host(self.state, "ckpt"),
            "net_state": to_host(self.net_state, "ckpt"),
            **self.extra_ckpt(),
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        self.logger.info("Checkpoint saved at %s", path)
        return path

    def load_ckpt(self, path: str):
        """Restore a checkpoint this package wrote; returns its epoch."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        self.state = from_host(self.state, payload["state"], self.device)
        self.net_state = from_host(self.net_state, payload["net_state"],
                                   self.device)
        self.bi = payload.get("bi", 0)
        return payload["epoch"]
