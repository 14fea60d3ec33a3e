"""Shared runner skeleton and predictive helpers (counterpart of
bayesdll_tpu.methods.base).

A method subclass provides:
  * `init_state(theta_init)`               -> sampler state
  * `_step(state, ns, x, y, step, sc)`     -> (state', ns', (loss, err_count))
  * `pred_state()` and `_predict_logits(ps, x, generator)` -> [S, B, K]
plus host hooks (`eval_ready`, `step_scalars`, `epoch_begin`,
`after_batch`).  `step` is the global step index: with the run's seed it
keys every random draw of that step.

Per-step loss and error stay on the device; the host reads them once per
epoch, so the training loop never waits on the card.

Predictive combination shared by the stochastic methods:
  logits = logsumexp(log_softmax(logits_all), sample_dim) - log(S)
the log of the Monte-Carlo averaged predictive probabilities.
"""

from __future__ import annotations

import dataclasses
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
from bayesdll_tpu_torch.utils import calibration

_LOG = logging.getLogger("bayesdll_tpu_torch")


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
    std = torch.sqrt(var)
    out = []
    for _ in range(nst):
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
        out.append(target.forward(mean + std * eps, net_state, x, train=False)[0])
    return torch.stack(out)


def to_host(obj):
    """A copy of `obj` with every tensor as a numpy array (dataclasses become
    dicts), for pickling."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True).numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_host(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    return obj


def from_host(template, saved, device):
    """Inverse of to_host: `template`'s structure filled from `saved`."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(saved).to(device)
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: from_host(getattr(template, f.name), saved[f.name], device)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: from_host(v, saved[k], device) for k, v in template.items()}
    return saved


class BaseRunner:
    method_name = "base"

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

        self.state = self.init_state(
            torch.as_tensor(theta_init, dtype=torch.float32)
            .to(self.device, copy=True))
        self.bi = 0  # global step counter
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

    def _to_device(self, a) -> torch.Tensor:
        """Host batch -> device.  To a card the copy goes from pinned memory
        and does not block, so the host never waits for the card's queue."""
        t = torch.as_tensor(a)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _one_step(self, ep: int, x, y):
        scalars = self.step_scalars(ep)
        self.state, self.net_state, metrics = self._step(
            self.state, self.net_state, self._to_device(x),
            self._to_device(y), self.bi, scalars)
        self.bi += 1
        return metrics

    def run_steps(self, ep: int, xs, ys, bi0: int):
        """len(xs) consecutive train steps from global step bi0, with no host
        hooks in between (counterpart of the JAX package's scanned steps).
        xs: [K, B, ...], ys: [K, B].  Returns stacked (loss[K], err[K]) on
        the device."""
        self.bi = bi0
        metrics = [self._one_step(ep, xs[k], ys[k]) for k in range(len(xs))]
        return (torch.stack([m[0] for m in metrics]),
                torch.stack([m[1] for m in metrics]))

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
        losses, errs, nb = [], [], 0
        bs = train_loader.batch_size
        for x, y, _valid in train_loader:
            loss, err = self._one_step(ep, x, y)
            losses.append(loss)
            errs.append(err)
            nb += bs
            self.after_batch(ep)
        # the one host read of the epoch
        loss = float(torch.stack(losses).sum()) * bs / nb
        err = float(torch.stack(errs).sum()) / nb
        return loss, err

    # ---- evaluation ---------------------------------------------------------

    @torch.no_grad()
    def evaluate(self, loader):
        """Monte-Carlo predictive evaluation.  Batch i draws from a generator
        keyed by (seed, EVAL, 0, i).

        Returns (loss, err, targets, logits, logits_all), logits_all [N, S, K].
        """
        ps = self.pred_state()
        loss_sum = torch.zeros((), device=self.device)
        err_sum = torch.zeros((), device=self.device)
        n = 0.0
        targets, logits_list, logits_all_list = [], [], []
        for i, (x, y, valid) in enumerate(loader):
            gen = rng.generator(self.device, self.cfg.seed, rng.EVAL, 0, i)
            yd, vd = self._to_device(y).long(), self._to_device(valid)
            la = self._predict_logits(ps, self._to_device(x), gen)
            logits = combine_mc_logits(la)
            picked = torch.log_softmax(logits, -1).gather(1, yd[:, None])[:, 0]
            loss_sum += torch.sum(-picked * vd)
            err_sum += torch.sum((torch.argmax(logits, -1) != yd).float() * vd)
            nv = int(valid.sum())
            n += nv
            targets.append(y[:nv])
            logits_list.append(logits[:nv].cpu().numpy())
            logits_all_list.append(la.transpose(0, 1)[:nv].cpu().numpy())
        return (float(loss_sum) / n, float(err_sum) / n,
                np.concatenate(targets), np.concatenate(logits_list),
                np.concatenate(logits_all_list))

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
        plot_dir = self.workdir if calibration.can_plot() else None
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
            "state": to_host(self.state),
            "net_state": to_host(self.net_state),
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
