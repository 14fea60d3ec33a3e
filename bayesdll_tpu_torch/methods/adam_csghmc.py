"""Adam-cSGHMC: cyclical SGHMC with Adam preconditioning, a likelihood
temperature and cold restarts (counterpart of
bayesdll_tpu.methods.adam_csghmc).

  * the Adam-SGHMC momentum (ops/fused.py::adam_sghmc_momentum) with the
    data gradient divided by a likelihood temperature:
        grad_U = g/T + mask*(theta-theta0)/sig^2/N;
  * the momentum OVERWRITES the gradient (reference `p.grad = v_momentum`)
    and torch-SGD then applies the cyclical lr again; the two go through
    ops/fused.py::adam_sghmc_update_, on the card one pass of the
    adam_sghmc_update kernel;
  * at every cycle boundary buf, v_mom, m, v2 and t are reset; with hparam
    perform_cold_restarts=1 and a re-init function set (`set_reinit_fn`),
    θ is also replaced by a fresh draw of the backbone's initialisers;
  * naive running moments, not Welford; the cycle likelihoods centre on
    the cycle mean;
  * the noise and, on the fused path, the bias corrections as in
    Adam-SGHMC (methods/adam_sghmc.py).  Cycle ends cut the fused path's
    segments, so within a segment t only counts up; the resets write the
    state's tensors in place, so a captured step keeps its addresses.

hparams: {prior_sig, Ninflate, nd, thin, bias, nst, momentum_decay, beta1,
beta2, epsilon, temperature, perform_cold_restarts}.
"""

from __future__ import annotations

import dataclasses

import torch

from bayesdll_tpu_torch.core.moments import RunningMoments
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.methods.adam_sghmc import (
    adam_hparams, bias_correction_rows, zero_adam_state)
from bayesdll_tpu_torch.methods.cyclical_base import CyclicalRunnerBase
from bayesdll_tpu_torch.ops import fused


@dataclasses.dataclass
class AdamCSGHMCState:
    theta: torch.Tensor
    buf: torch.Tensor
    v_mom: torch.Tensor
    m: torch.Tensor
    v2: torch.Tensor
    moments: RunningMoments
    t: int = 0
    step: int = 0


class Runner(CyclicalRunnerBase):
    method_name = "adam_csghmc"
    LIK_CENTER = "cycle_mean"

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        hp = cfg.hparams
        self.adam = adam_hparams(hp)
        self.temperature = float(hp.get("temperature", 1.0))
        super().__init__(target, theta_init, net_state, cfg, **kw)
        self.n_eff = float(target.nd_size) * self.ninflate
        self.prior_mask = target.prior_mask(self.bias_mode)

    def set_reinit_fn(self, fn):
        """fn(cycle[, seed=]) -> a fresh flat θ of length target.dim, for
        cold restarts; a multi-chain run passes each chain's seed
        (cli/demo.py::make_reinit_fn builds it)."""
        self._reinit_fn = fn

    def init_state(self, theta_init):
        return AdamCSGHMCState(
            theta=theta_init, **zero_adam_state(theta_init),
            moments=RunningMoments.zeros(theta_init.shape[0],
                                         theta_init.device))

    def _cycle_reset(self, state, theta):
        if theta is not None:
            state.theta.copy_(theta)
        for name in ("buf", "v_mom", "m", "v2"):
            getattr(state, name).zero_()
        state.t = 0
        self.logger.info(
            "All optimizer states (momentum, m, v, t) reset for new cycle.")

    def bias_corrections(self, k: int):
        return bias_correction_rows(self.state.t, self.adam, k)

    def _step(self, state, ns, x, y, step, scalars):
        lr_vec = self.cyclical_lr_vec(scalars["lr"])
        theta_leaf = state.theta.detach().requires_grad_()
        logits, new_ns = self.target.forward(theta_leaf, ns, x, train=True)
        loss = base.ce_loss(logits, y)
        g, = torch.autograd.grad(loss, theta_leaf)
        logits = logits.detach()

        state.t += 1
        # v_mom, m, v2, theta and buf change IN PLACE once the graph is
        # consumed
        fused.adam_sghmc_update_(
            g, state.theta, self.target.theta0, state.v_mom, state.m,
            state.v2, state.buf, state.t, self.prior_mask, lr_vec,
            add_g=False, momentum=self.cfg.momentum, sgd_count=state.step,
            prior_sig=self.prior_sig, n_eff=self.n_eff, nd=self.nd,
            temperature=self.temperature, bc=scalars.get("bc"),
            **self.draw_args(step, scalars), **self.adam)
        self.collect_sample(state, scalars)
        state.step += 1
        return state, new_ns, (loss.detach(), base.err_count(logits, y))
