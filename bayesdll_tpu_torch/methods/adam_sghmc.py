"""Adam-SGHMC: SGHMC with Adam preconditioning (counterpart of
bayesdll_tpu.methods.adam_sghmc).

SGLD's runner (methods/sgld.py) with the crafted gradient of
ops/fused.py::adam_sghmc_update:

    grad_U = g + mask * (theta - theta0) / sig^2 / N
    m  <- b1 m + (1-b1) grad_U ;  v2 <- b2 v2 + (1-b2) grad_U^2
    m^ = m/(1-b1^t) ;  v^ = v2/(1-b2^t) ;  P = 1/(sqrt(v^)+eps)
    v_mom <- (1-alpha) v_mom + lr * m^ * P + nd*sqrt(2*alpha*P/N)*z
    g' = g + v_mom

after which the torch-SGD step applies lr again, as in SGHMC.  z is a
whole-vector draw keyed (seed, step) on the Adam stream, taken only where
nd != 0.  The momentum and the SGD step go through ops/fused.py::
adam_sghmc_update_: on the card one pass of the adam_sghmc_update kernel,
which draws z in the pass (the JAX package leaves the update to XLA and
has no Pallas kernel for it); on the CPU the plain PyTorch versions.  On
the fused path the bias corrections 1 - b^t come from the step's scalars
(`bias_corrections`, one row per step), since a captured step cannot take
them from the host count t.  Moments and predictive are SGLD's.
Checkpoints carry beta1, beta2 and epsilon.

hparams: {prior_sig, Ninflate, nd, burnin, thin, bias, nst, momentum_decay,
beta1, beta2, epsilon}.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bayesdll_tpu_torch.core.moments import RunningMoments
from bayesdll_tpu_torch.methods import sgld
from bayesdll_tpu_torch.ops import fused


@dataclasses.dataclass
class AdamSGHMCState:
    theta: torch.Tensor
    buf: torch.Tensor    # torch-SGD momentum buffer
    v_mom: torch.Tensor  # SGHMC momentum
    m: torch.Tensor      # Adam first moment
    v2: torch.Tensor     # Adam second moment
    moments: RunningMoments
    t: int = 0           # Adam step
    step: int = 0


def adam_hparams(hp) -> dict:
    """(momentum_decay, beta1, beta2, epsilon) with the reference's Adam
    defaults, as keyword arguments of the Adam update."""
    return dict(alpha=float(hp.get("momentum_decay", 0.05)),
                beta1=float(hp.get("beta1", 0.9)),
                beta2=float(hp.get("beta2", 0.999)),
                eps_adam=float(hp.get("epsilon", 1e-8)))


def zero_adam_state(theta: torch.Tensor) -> dict:
    """Fresh buf, v_mom, m and v2: separate zero tensors."""
    return {k: torch.zeros_like(theta) for k in ("buf", "v_mom", "m", "v2")}


def bias_correction_rows(t: int, adam: dict, k: int) -> np.ndarray:
    """[k, 2] fp32: the bias corrections of the k steps after Adam step t
    (their t + 1, ..., t + k), each as the per-step path computes it."""
    return np.array([fused.adam_bias_corrections(t + j, adam["beta1"],
                                                 adam["beta2"])
                     for j in range(1, k + 1)], np.float32).reshape(k, 2)


class Runner(sgld.Runner):
    method_name = "adam_sghmc"

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        self.adam = adam_hparams(cfg.hparams)
        super().__init__(target, theta_init, net_state, cfg, **kw)

    def init_state(self, theta_init):
        return AdamSGHMCState(
            theta=theta_init, **zero_adam_state(theta_init),
            moments=RunningMoments.zeros(theta_init.shape[0],
                                         theta_init.device))

    def bias_corrections(self, k: int):
        return bias_correction_rows(self.state.t, self.adam, k)

    def _update(self, state, g, step, scalars):
        """The Adam state advanced and the SGD step on g + v_mom' (v_mom, m,
        v2, theta and buf written in place)."""
        state.t += 1
        fused.adam_sghmc_update_(
            g, state.theta, self.target.theta0, state.v_mom, state.m,
            state.v2, state.buf, state.t, self.prior_mask, self.lr_vec,
            add_g=True, momentum=self.cfg.momentum, sgd_count=state.step,
            prior_sig=self.prior_sig, n_eff=self.n_eff, nd=self.nd,
            bc=scalars.get("bc"), **self.draw_args(step, scalars),
            **self.adam)

    def extra_ckpt(self):
        a = self.adam
        return {**super().extra_ckpt(), "momentum_decay": a["alpha"],
                "beta1": a["beta1"], "beta2": a["beta2"],
                "epsilon": a["eps_adam"]}
