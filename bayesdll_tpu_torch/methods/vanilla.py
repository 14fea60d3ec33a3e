"""Vanilla (MAP) baseline (counterpart of bayesdll_tpu.methods.vanilla).

Deterministic training with loss = CE + 0.5*wd*||mask*(theta-theta0)||^2,
as one gradient pass over the flat vector:

    g' = g + wd * mask * (theta - theta0),  then a torch-SGD step

where the mask drops the bias elements under bias='ignore' and keeps every
element under bias='penalty' (the default).

hparams: {wd, bias in ('penalty'|'ignore')}.
"""

from __future__ import annotations

import dataclasses

import torch

from bayesdll_tpu_torch.core.sgd import sgd_step
from bayesdll_tpu_torch.methods import base


@dataclasses.dataclass
class VanillaState:
    theta: torch.Tensor
    buf: torch.Tensor
    step: int = 0


class Runner(base.BaseRunner):
    method_name = "vanilla"

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        self.wd = float(cfg.hparams.get("wd", 0.0))
        self.bias_mode_vanilla = cfg.hparams.get("bias", "penalty")
        super().__init__(target, theta_init, net_state, cfg, **kw)
        self.mask = (1.0 - target.is_bias.float()
                     if self.bias_mode_vanilla == "ignore"
                     else torch.ones(target.dim, device=self.device))
        self.lr_vec = target.lr_vec(cfg.lr, cfg.lr_head)

    def init_state(self, theta_init):
        return VanillaState(theta=theta_init, buf=torch.zeros_like(theta_init))

    def _step(self, state, ns, x, y, step, scalars):
        theta_leaf = state.theta.detach().requires_grad_()
        logits, new_ns = self.target.forward(theta_leaf, ns, x, train=True)
        loss_ce = base.ce_loss(logits, y)
        g, = torch.autograd.grad(loss_ce, theta_leaf)
        logits = logits.detach()

        dev = state.theta - self.target.theta0
        loss_l2 = self.shard_sum(torch.sum(self.mask * dev * dev))
        g = g + self.wd * self.mask * dev
        # theta and buf change IN PLACE once the graph is consumed
        sgd_step(state.theta, g, state.buf, self.lr_vec, self.cfg.momentum,
                 state.step)
        state.step += 1
        loss = loss_ce.detach() + 0.5 * self.wd * loss_l2
        return state, new_ns, (loss, base.err_count(logits, y))

    def pred_state(self):
        return self.state.theta

    def _predict_logits(self, theta, x, generator):
        return self.target.forward(theta, self.net_state, x, train=False)[0][None]
