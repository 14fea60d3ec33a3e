"""cSGLD: cyclical SGLD with the GMM snapshot-ensemble predictive
(counterpart of bayesdll_tpu.methods.csgld).

SGLD's step (ops/fused.py::sgld_update_, then a torch-SGD step) driven by
the cyclical cosine step size, with the head lr scaled by lr_head/lr;
per-cycle running moments, cycle-end snapshots, full-train likelihoods
centred on the live iterate and the GMM predictive come from
CyclicalRunnerBase.  The optional `clip_grad` clips the crafted gradient
(noise included) to that global norm before the step, on the device.

hparams: {prior_sig, Ninflate, nd, thin, bias, nst [, clip_grad]}.
"""

from __future__ import annotations

import dataclasses

import torch

from bayesdll_tpu_torch.core.moments import RunningMoments
from bayesdll_tpu_torch.core.sgd import sgd_step
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.methods.cyclical_base import CyclicalRunnerBase
from bayesdll_tpu_torch.ops import fused


@dataclasses.dataclass
class CSGLDState:
    theta: torch.Tensor
    buf: torch.Tensor  # torch-SGD momentum buffer
    moments: RunningMoments
    step: int = 0


class Runner(CyclicalRunnerBase):
    method_name = "csgld"
    LIK_CENTER = "iterate"

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        self.clip_grad = float(cfg.hparams["clip_grad"]) \
            if "clip_grad" in cfg.hparams else None
        super().__init__(target, theta_init, net_state, cfg, **kw)
        self.n_eff = float(target.nd_size) * self.ninflate
        self.prior_mask = target.prior_mask(self.bias_mode)

    def init_state(self, theta_init):
        return CSGLDState(theta=theta_init, buf=torch.zeros_like(theta_init),
                          moments=RunningMoments.zeros(theta_init.shape[0],
                                                       theta_init.device))

    def _step(self, state, ns, x, y, step, scalars):
        lr_vec = self.cyclical_lr_vec(scalars["lr"])
        theta_leaf = state.theta.detach().requires_grad_()
        logits, new_ns = self.target.forward(theta_leaf, ns, x, train=True)
        loss = base.ce_loss(logits, y)
        g, = torch.autograd.grad(loss, theta_leaf)
        logits = logits.detach()

        # g, then theta and buf, change IN PLACE once the graph is consumed
        fused.sgld_update_(g, state.theta, self.target.theta0,
                           self.prior_mask, lr_vec, prior_sig=self.prior_sig,
                           n_eff=self.n_eff, nd=self.nd,
                           **self.draw_args(step, scalars))
        if self.clip_grad is not None:
            norm = torch.linalg.vector_norm(g)
            g.mul_(torch.clamp(self.clip_grad / torch.clamp(norm, min=1e-12),
                               max=1.0))
        sgd_step(state.theta, g, state.buf, lr_vec, self.cfg.momentum,
                 state.step)
        self.collect_sample(state, scalars)
        state.step += 1
        return state, new_ns, (loss.detach(), base.err_count(logits, y))
