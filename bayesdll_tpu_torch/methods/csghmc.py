"""cSGHMC: cyclical SGHMC, the north-star method (counterpart of
bayesdll_tpu.methods.csghmc).

Per step, one pass over the flat vector (ops/fused.py::csghmc_update_):

    grad_U = g + prior_sig * theta        (decay toward 0, ignoring theta0,
                                           as the reference does)
    v      <- (1-alpha) v - lr_elem * grad_U
              + [nd * sqrt(2*alpha*lr)/N * eps  on sampling steps]
    theta  <- theta + v

Per-cycle moments use Welford mean + M2 with the correct count by default;
BAYESDLL_TPU_REF_QUIRKS=welford_count selects the reference's doubled count
(core/moments.py::RefWelfordMoments).

hparams: {prior_sig, Ninflate, nd, thin, bias, nst, momentum_decay}.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from bayesdll_tpu_torch.core.moments import RefWelfordMoments, WelfordMoments
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.methods.cyclical_base import CyclicalRunnerBase
from bayesdll_tpu_torch.ops import fused


@dataclasses.dataclass
class CSGHMCState:
    theta: torch.Tensor
    v: torch.Tensor
    moments: WelfordMoments
    step: int = 0


class Runner(CyclicalRunnerBase):
    method_name = "csghmc"
    LIK_CENTER = "cycle_mean"
    periodic_point_eval = True

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        self.momentum_decay = float(cfg.hparams.get("momentum_decay", 0.05))
        super().__init__(target, theta_init, net_state, cfg, **kw)

    def init_state(self, theta_init):
        quirks = os.environ.get("BAYESDLL_TPU_REF_QUIRKS", "")
        cls = RefWelfordMoments if "welford_count" in quirks else WelfordMoments
        return CSGHMCState(theta=theta_init, v=torch.zeros_like(theta_init),
                           moments=cls.zeros(theta_init.shape[0],
                                             theta_init.device))

    def _step(self, state, ns, x, y, step, scalars):
        t = self.target
        n_eff = float(t.nd_size) * self.ninflate
        lr_vec = self.cyclical_lr_vec(scalars["lr"])

        # the views into this leaf carry the forward, so the gradient comes
        # back as one flat tensor; autograd.grad accumulates nothing
        theta_leaf = state.theta.detach().requires_grad_()
        logits, new_ns = t.forward(theta_leaf, ns, x, train=True)
        loss = base.ce_loss(logits, y)
        g, = torch.autograd.grad(loss, theta_leaf)
        logits = logits.detach()

        # updates state.theta and state.v IN PLACE (on CUDA, in the kernel);
        # theta_leaf shares their storage, which is safe because its graph
        # has been consumed above
        fused.csghmc_update_(
            g, state.theta, state.v, prior_sig=self.prior_sig, n_eff=n_eff,
            nd=self.nd, alpha=self.momentum_decay, lr=lr_vec,
            should_sample=scalars["should_sample"],
            **self.draw_args(step, scalars))
        self.collect_sample(state, scalars)
        state.step += 1
        return state, new_ns, (loss.detach(), base.err_count(logits, y))
