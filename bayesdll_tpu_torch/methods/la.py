"""Diagonal Laplace approximation (counterpart of bayesdll_tpu.methods.la),
in two stages.

Stage 1 (MAP): CE + 0.5*||mask*(theta-theta0)||^2/sig^2/N through the
  crafted gradient g' = g + mask*(theta-theta0)/sig^2/N and a torch-SGD
  step; the θ of the best evaluation loss is kept (a copy).

Stage 2 (posterior precision): 1/sig^2 (1e-8 on bias elements under
  bias='uninformative'), plus the squared per-example CE gradients at the
  MAP θ over every training example once (`train_loader.eval_view()`:
  unshuffled, no batch dropped, the padded tail weighted out by `valid`);
  vars = 1/precision.  The forward runs in eval mode (BatchNorm on its
  running statistics, which stage 2 leaves as they are).  The per-example
  gradients are `torch.func.vmap(torch.func.grad(...))` over microbatches
  of `fisher_microbatch` examples, and a batch's remainder one example at
  a time.

Predictive: theta ~ N(theta_MAP, vars), Monte-Carlo averaged; during stage
1, the point estimate.

hparams: {prior_sig, Ninflate, bias, nst, fisher_microbatch}.

A backbone whose per-example gradients are not its batch's terms (V-MoE:
one example routed alone has its own expert capacity) declares
`per_example_grads = False` and is refused here.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.func import grad, vmap

from bayesdll_tpu_torch.core.sgd import sgd_step
from bayesdll_tpu_torch.methods import base


@dataclasses.dataclass
class LAState:
    theta: torch.Tensor
    buf: torch.Tensor
    step: int = 0


def per_example_grad_fn(target, net_state):
    """g(theta, x_i, y_i): the gradient of one example's CE at theta, in
    eval mode."""
    def one_example_loss(theta, xi, yi):
        logits, _ = target.forward(theta, net_state, xi[None], train=False)
        return base.ce_loss(logits, yi[None])
    return grad(one_example_loss)


def fisher_accumulate(target, theta, net_state, precision, xb, yb, vb,
                      microbatch: int):
    """precision += sum_i valid_i * g_i^2 over one batch (in place): vmapped
    over whole microbatches, the remainder one example at a time."""
    grad_one = per_example_grad_fn(target, net_state)
    batched = vmap(grad_one, in_dims=(None, 0, 0))
    mb = microbatch
    nb = xb.shape[0] // mb
    for c in range(nb):
        sl = slice(c * mb, (c + 1) * mb)
        g = batched(theta, xb[sl], yb[sl])
        precision += torch.sum(g * g * vb[sl, None], dim=0)
    for i in range(nb * mb, xb.shape[0]):
        g = grad_one(theta, xb[i], yb[i])
        precision += g * g * vb[i]
    return precision


class Runner(base.BaseRunner):
    method_name = "la"

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        if not getattr(target.module, "per_example_grads", True):
            raise ValueError(
                f"Laplace ('la') is not supported for "
                f"{type(target.module).__name__}: its Fisher takes "
                f"per-example gradients under torch.func.vmap, and an "
                f"example routed alone has its own expert capacity, so they "
                f"are another function's")
        hp = cfg.hparams
        self.ninflate = float(hp.get("Ninflate", 1.0))
        self.fisher_microbatch = int(hp.get("fisher_microbatch", 16))
        super().__init__(target, theta_init, net_state, cfg, **kw)
        self.n_eff = float(target.nd_size) * self.ninflate
        self.mask = target.prior_mask(self.bias_mode)
        self.lr_vec = target.lr_vec(cfg.lr, cfg.lr_head)
        self.map_theta = None
        self.post_vars = None  # set in stage 2

    def init_state(self, theta_init):
        return LAState(theta=theta_init, buf=torch.zeros_like(theta_init))

    # ---- stage 1: MAP ------------------------------------------------------

    def _step(self, state, ns, x, y, step, scalars):
        theta_leaf = state.theta.detach().requires_grad_()
        logits, new_ns = self.target.forward(theta_leaf, ns, x, train=True)
        loss_ce = base.ce_loss(logits, y)
        g, = torch.autograd.grad(loss_ce, theta_leaf)
        logits = logits.detach()

        sig2 = self.prior_sig ** 2
        dev = state.theta - self.target.theta0
        g = g + self.mask * dev / sig2 / self.n_eff
        loss = loss_ce.detach() \
            + 0.5 * self.shard_sum(torch.sum(self.mask * dev * dev)) / sig2 \
            / self.n_eff
        # theta and buf change IN PLACE once the graph is consumed
        sgd_step(state.theta, g, state.buf, self.lr_vec, self.cfg.momentum,
                 state.step)
        state.step += 1
        return state, new_ns, (loss, base.err_count(logits, y))

    def pred_state(self):
        if self.post_vars is None:  # stage 1: the point estimate
            return self.state.theta, None
        return self.map_theta, self.post_vars

    def _predict_logits(self, pred_state, x, generator):
        mean, var = pred_state
        if var is None:
            return self.target.forward(mean, self.net_state, x,
                                       train=False)[0][None]
        return base.gaussian_sample_logits(self.target, self.net_state, mean,
                                           var, x, generator, self.nst)

    # ---- the two stages ----------------------------------------------------

    def train(self, train_loader, val_loader, test_loader, start_epoch=0):
        cfg, logger = self.cfg, self.logger
        logger.info("Start training (stage 1: MAP)...")
        best_loss, best_theta = np.inf, None
        losses, errs = [], []
        tic0 = time.time()
        for ep in range(start_epoch, cfg.epochs):
            tic = time.time()
            loss, err = self.train_one_epoch(ep, train_loader)
            losses.append(loss)
            errs.append(err)
            logger.info(
                "[Epoch %d/%d] Training summary: loss = %.4f, prediction "
                "error = %.4f (time: %.4f seconds)",
                ep, cfg.epochs, loss, err, time.time() - tic)
            if ep % cfg.test_eval_freq == 0:
                loader = val_loader if val_loader is not None else test_loader
                vloss, verr, *_ = self.evaluate(loader)
                logger.info("(Epoch %d) MAP eval: loss = %.4f, err = %.4f",
                            ep, vloss, verr)
                if vloss < best_loss:
                    # a copy: the next step writes θ in place
                    best_loss, best_theta = vloss, self.state.theta.clone()
                    logger.info("Best MAP loss so far @epoch %d: %.4f", ep,
                                vloss)
        self.map_theta = best_theta if best_theta is not None \
            else self.state.theta
        self.results.update(train_losses=losses, train_errors=errs,
                            map_time=time.time() - tic0)

        logger.info("Stage 2: estimating diagonal posterior variance "
                    "(vmapped per-example Fisher)...")
        tic = time.time()
        self.post_vars = self.estimate_variance(train_loader)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.results["fisher_time"] = time.time() - tic
        logger.info("Variance estimation done (time: %.4f seconds)",
                    self.results["fisher_time"])

        # final evaluation and calibration with the Laplace predictive
        best = self._eval_and_maybe_save(cfg.epochs - 1, val_loader,
                                         test_loader, np.inf)
        self.results["best_loss"] = float(best)
        self.results["total_time"] = time.time() - tic0
        return self.results

    @torch.no_grad()
    def estimate_variance(self, train_loader):
        """Diagonal empirical-Fisher posterior variance (reference
        `methods/la.py:360-393`) at self.map_theta."""
        precision = self.mask / (self.prior_sig ** 2) \
            + (1.0 - self.mask) * 1e-8
        loader = train_loader.eval_view() \
            if hasattr(train_loader, "eval_view") else train_loader
        for xb, yb, valid in loader:
            fisher_accumulate(self.target, self.map_theta, self.net_state,
                              precision, self._to_device(xb),
                              self._to_device(yb).long(),
                              self._to_device(valid), self.fisher_microbatch)
        return 1.0 / precision

    def extra_ckpt(self):
        out = {"ninflate": self.ninflate}
        if self.post_vars is not None:
            out["map_theta"] = base.to_host(self.map_theta)
            out["vars"] = base.to_host(self.post_vars)
        return out
