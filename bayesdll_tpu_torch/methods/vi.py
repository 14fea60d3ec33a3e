"""Mean-field Gaussian variational inference (counterpart of
bayesdll_tpu.methods.vi).

q(theta) = N(m, diag(s^2)) with s = clamp(s_, S_CLAMP); s_ starts at S_INIT
and m at θ's initial value.  Per step, theta = m + s * eps with eps a
whole-vector draw keyed (seed, step) on the VI stream (ops/fused.py::draw_:
the philox_draw kernel on the card, the generator keyed (seed, VI, step) on
the CPU), and the reference's hand-written reparameterisation gradients:

    g_m  = kmask * (g + kld * (m - theta0) / sig^2 / ND)
    g_s_ = kmask * (g * (theta - m)/s + kld * (s/sig^2 - 1/s) / ND)

with g the gradient of the mean CE at theta, and the closed-form KL
    KL = 0.5 * sum(kmask * (((m-theta0)^2 + s^2)/sig^2 - log(s^2/sig^2) - 1)),
loss = NLL + kld * KL / ND; then one torch-SGD step each for m and s_.

Under bias='uninformative' kmask is 0 on the bias elements: their m and s_
receive no gradient at all and never move (the reference's guard wraps
both gradient writes).  The predictive is N(m, s^2), Monte-Carlo averaged.

hparams: {prior_sig, kld, bias, nst}.
"""

from __future__ import annotations

import dataclasses

import torch

from bayesdll_tpu_torch.core.sgd import sgd_step
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.ops import fused, kernels

S_CLAMP = 1e-8
S_INIT = 1e-6


def elbo_terms(g, theta, m, s, theta0, kmask, *, sig2: float, kld: float,
               nd_size: float):
    """(g_m, g_s_, KL): the reference's hand-written gradients of
    NLL + kld * KL / ND with respect to m and s_ at the draw theta = m + s *
    eps, given g, the NLL gradient at theta, and the closed-form KL, in the
    JAX package's operation order."""
    dev = m - theta0
    v = s * s
    kl = 0.5 * torch.sum(
        kmask * ((dev * dev + v) / sig2 - torch.log(v / sig2) - 1.0))
    g_m = kmask * (g + kld * dev / sig2 / nd_size)
    g_s = kmask * (g * ((theta - m) / s) + kld * (s / sig2 - 1.0 / s) / nd_size)
    return g_m, g_s, kl


@dataclasses.dataclass
class VIState:
    m: torch.Tensor
    s_: torch.Tensor
    buf_m: torch.Tensor
    buf_s: torch.Tensor
    step: int = 0


class Runner(base.BaseRunner):
    method_name = "vi"

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        self.kld = float(cfg.hparams.get("kld", 1.0))
        super().__init__(target, theta_init, net_state, cfg, **kw)
        self.kmask = (1.0 - target.is_bias.float()
                      if self.bias_mode == "uninformative"
                      else torch.ones(target.dim, device=self.device))
        self.lr_vec = target.lr_vec(cfg.lr, cfg.lr_head)

    def init_state(self, theta_init):
        return VIState(m=theta_init, s_=torch.full_like(theta_init, S_INIT),
                       buf_m=torch.zeros_like(theta_init),
                       buf_s=torch.zeros_like(theta_init))

    def _train_normal(self, step, scalars) -> torch.Tensor:
        """The reparameterisation draw eps ~ N(0, I) of the step: `step`
        on the per-step path, the scalars' device row on the fused path."""
        return fused.draw_(self.state.m, kind="normal",
                           stream=kernels.STREAM_VI,
                           **self.draw_args(step, scalars))

    def _step(self, state, ns, x, y, step, scalars):
        t = self.target
        nd_size = float(t.nd_size)
        s = torch.clamp(state.s_, min=S_CLAMP)
        theta = (state.m + s * self._train_normal(step, scalars)
                 ).requires_grad_()
        logits, new_ns = t.forward(theta, ns, x, train=True)
        loss_nll = base.ce_loss(logits, y)
        g, = torch.autograd.grad(loss_nll, theta)
        logits, theta = logits.detach(), theta.detach()

        g_m, g_s, loss_kl = elbo_terms(
            g, theta, state.m, s, t.theta0, self.kmask,
            sig2=self.prior_sig ** 2, kld=self.kld, nd_size=nd_size)
        loss_kl = self.shard_sum(loss_kl)
        # m, s_ and their buffers change IN PLACE
        sgd_step(state.m, g_m, state.buf_m, self.lr_vec, self.cfg.momentum,
                 state.step)
        sgd_step(state.s_, g_s, state.buf_s, self.lr_vec, self.cfg.momentum,
                 state.step)
        state.step += 1
        loss = loss_nll.detach() + self.kld * loss_kl / nd_size
        return state, new_ns, (loss, base.err_count(logits, y))

    def iterate(self, state):
        return state.m

    def with_iterate(self, state, vec):
        return dataclasses.replace(state, m=vec)

    def pred_state(self):
        s = torch.clamp(self.state.s_, min=S_CLAMP)
        return self.state.m, s * s

    def _predict_logits(self, pred_state, x, generator):
        mean, var = pred_state
        return base.gaussian_sample_logits(self.target, self.net_state, mean,
                                           var, x, generator, self.nst)
