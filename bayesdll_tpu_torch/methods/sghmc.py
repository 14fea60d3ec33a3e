"""SGHMC: stochastic gradient Hamiltonian Monte Carlo (counterpart of
bayesdll_tpu.methods.sghmc).

SGLD's runner (methods/sgld.py) with a per-parameter momentum v:

    grad_U = g + mask * (theta - theta0) / prior_sig^2 / N
    v      <- (1 - alpha) v + lr_elem * grad_U
              + nd * sqrt(2 * alpha / (N * lr_elem)) * eps
    g'     = g + v                        (ops/fused.py::sghmc_update_)

after which the torch-SGD step applies lr_elem again: the reference's
double-lr quirk, kept.  Moments and predictive are SGLD's.

hparams: {prior_sig, Ninflate, nd, burnin, thin, bias, nst, momentum_decay}.
"""

from __future__ import annotations

import dataclasses

import torch

from bayesdll_tpu_torch.core.moments import RunningMoments
from bayesdll_tpu_torch.methods import sgld
from bayesdll_tpu_torch.ops import fused


@dataclasses.dataclass
class SGHMCState:
    theta: torch.Tensor
    buf: torch.Tensor  # torch-SGD momentum buffer
    v: torch.Tensor    # SGHMC momentum
    moments: RunningMoments
    step: int = 0


class Runner(sgld.Runner):
    method_name = "sghmc"

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        self.momentum_decay = float(cfg.hparams.get("momentum_decay", 0.05))
        super().__init__(target, theta_init, net_state, cfg, **kw)

    def init_state(self, theta_init):
        return SGHMCState(theta=theta_init, buf=torch.zeros_like(theta_init),
                          v=torch.zeros_like(theta_init),
                          moments=RunningMoments.zeros(theta_init.shape[0],
                                                       theta_init.device))

    def _crafted_gradient(self, state, g, step, scalars):
        """g -> g + v' and v -> v', both in place."""
        return fused.sghmc_update_(
            g, state.theta, self.target.theta0, state.v, self.prior_mask,
            self.lr_vec, prior_sig=self.prior_sig, n_eff=self.n_eff,
            nd=self.nd, alpha=self.momentum_decay,
            **self.draw_args(step, scalars))[0]

    def extra_ckpt(self):
        return {**super().extra_ckpt(), "momentum_decay": self.momentum_decay}
