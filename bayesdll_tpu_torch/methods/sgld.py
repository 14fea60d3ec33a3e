"""SGLD: stochastic gradient Langevin dynamics (counterpart of
bayesdll_tpu.methods.sgld).

Per step, after the gradient g of the mean cross-entropy:

    g'    = g + mask * (theta - theta0) / prior_sig^2 / N
              + nd * sqrt(2 / (N * lr_elem)) * eps     (ops/fused.py::sgld_update_)
    theta <- torch-SGD step with g' and momentum mu    (core/sgd.py)

with N = ND * Ninflate, the per-element lr (body and head) and the prior
pull dropped on bias elements when bias is 'uninformative'.  lr_elem and
the prior mask are constant for the run, so they are built once.

Posterior moments run over thinned iterates after burn-in: at the start of
epoch `burnin` they are seeded with the iterate (cnt = 1), and step bi
collects when (bi + 1) % thin == 0.  The predictive is the Gaussian
theta ~ N(mom1, ratio * (mom2 - mom1^2)), Monte-Carlo averaged.

hparams: {prior_sig, Ninflate, nd, burnin (epochs), thin (steps), bias, nst}.
"""

from __future__ import annotations

import dataclasses

import torch

from bayesdll_tpu_torch.core.moments import RunningMoments
from bayesdll_tpu_torch.core.sgd import sgd_step
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.ops import fused


@dataclasses.dataclass
class SGLDState:
    theta: torch.Tensor
    buf: torch.Tensor  # torch-SGD momentum buffer
    moments: RunningMoments
    step: int = 0


class Runner(base.BaseRunner):
    method_name = "sgld"

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        hp = cfg.hparams
        self.ninflate = float(hp.get("Ninflate", 1.0))
        self.nd = float(hp.get("nd", 1.0))
        self.burnin = int(hp.get("burnin", 0))
        self.thin = max(1, int(hp.get("thin", 1)))
        super().__init__(target, theta_init, net_state, cfg, **kw)
        self.n_eff = float(target.nd_size) * self.ninflate
        self.lr_vec = target.lr_vec(cfg.lr, cfg.lr_head)
        self.prior_mask = target.prior_mask(self.bias_mode)

    def init_state(self, theta_init):
        return SGLDState(theta=theta_init, buf=torch.zeros_like(theta_init),
                         moments=RunningMoments.zeros(theta_init.shape[0],
                                                      theta_init.device))

    def epoch_begin(self, ep: int):
        if ep == self.burnin:
            self.logger.info(
                "(leaving burnin period) start collecting posterior samples")
            # in place: a captured graph of the step keeps its addresses
            self.state.moments.reset_from(self.state.theta)

    def step_scalars(self, ep: int) -> dict:
        # the reference counts the step before its thinning test
        return {"collect": ep >= self.burnin and (self.bi + 1) % self.thin == 0}

    def _fused_key(self, ep: int):
        return ep >= self.burnin

    def eval_ready(self, ep: int) -> bool:
        return ep >= self.burnin

    def _crafted_gradient(self, state, g, step, scalars):
        """The gradient SGD takes: here g' written over g in place."""
        return fused.sgld_update_(
            g, state.theta, self.target.theta0, self.prior_mask, self.lr_vec,
            prior_sig=self.prior_sig, n_eff=self.n_eff, nd=self.nd,
            **self.draw_args(step, scalars))

    def _update(self, state, g, step, scalars):
        """The crafted gradient, then the torch-SGD step on it."""
        g = self._crafted_gradient(state, g, step, scalars)
        sgd_step(state.theta, g, state.buf, self.lr_vec, self.cfg.momentum,
                 state.step)

    def _step(self, state, ns, x, y, step, scalars):
        # the views into this leaf carry the forward, so the gradient comes
        # back as one flat tensor; autograd.grad accumulates nothing
        theta_leaf = state.theta.detach().requires_grad_()
        logits, new_ns = self.target.forward(theta_leaf, ns, x, train=True)
        loss = base.ce_loss(logits, y)
        g, = torch.autograd.grad(loss, theta_leaf)
        logits = logits.detach()

        # theta and buf change IN PLACE; theta_leaf shares theta's storage,
        # which is safe because its graph has been consumed above
        self._update(state, g, step, scalars)
        self.collect_sample(state, scalars)
        state.step += 1
        return state, new_ns, (loss.detach(), base.err_count(logits, y))

    def pred_state(self):
        return self.state.moments.mean_var()

    def _predict_logits(self, pred_state, x, generator):
        mean, var = pred_state
        return base.gaussian_sample_logits(self.target, self.net_state, mean,
                                           var, x, generator, self.nst)

    def extra_ckpt(self):
        return {"burnin": self.burnin, "thin": self.thin, "nst": self.nst}
