"""MC-dropout as approximate Bayesian inference on weights (counterpart of
bayesdll_tpu.methods.mc_dropout).

The variational posterior is a Bernoulli spike mixture per weight,
    q(theta_i) = (1-p) N(m_i, eps^2) + p N(theta0_i, eps^2):
dropout of each weight toward the prior mean, not of activations.  Per
step, a keep-mask z ~ Bern(1-p_drop) per element (from a whole-vector
uniform draw keyed (seed, step) on the MC-dropout stream, ops/fused.py::
draw_: the philox_draw kernel on the card, the generator keyed (seed,
MC_DROPOUT, step) on the CPU), theta = z*m + (1-z)*theta0, and

    g_m = g * z + kld * coeff * (m - theta0) / sig^2 / ND
    KL  = 0.5 * sum(coeff * (m - theta0)^2) / sig^2,  loss = NLL + kld*KL/ND

with coeff per element from the bias mode (`_kl_coeff`):
  'gaussian' (the default, and what an unknown mode falls back to) - biases
             keep z = 1 and an unscaled KL term;
  'spikymix' - biases are treated like weights;
  'ignore'   - biases keep z = 1 and have no KL term.
The predictive draws a fresh z for each of max(nst, 1) samples, from the
evaluation's host generator.

The JAX package hands its forward a dropout key, but no backbone of either
package has dropout layers (every one's `has_dropout` is False), so the
port's forward takes none.

hparams: {prior_sig, p_drop, kld, bias, nst}.
"""

from __future__ import annotations

import dataclasses

import torch

from bayesdll_tpu_torch.core.sgd import sgd_step
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.ops import fused, kernels

BIAS_MODES = ("gaussian", "spikymix", "ignore")


@dataclasses.dataclass
class MCDropState:
    m: torch.Tensor
    buf: torch.Tensor
    step: int = 0


class Runner(base.BaseRunner):
    method_name = "mc_dropout"

    def __init__(self, target, theta_init, net_state, cfg, **kw):
        self.p_drop = float(cfg.hparams.get("p_drop", 0.1))
        self.kld = float(cfg.hparams.get("kld", 1.0))
        super().__init__(target, theta_init, net_state, cfg, **kw)
        if self.bias_mode not in BIAS_MODES:
            self.bias_mode = "gaussian"
        self.lr_vec = target.lr_vec(cfg.lr, cfg.lr_head)

    def init_state(self, theta_init):
        return MCDropState(m=theta_init, buf=torch.zeros_like(theta_init))

    def _uniform(self, generator) -> torch.Tensor:
        return torch.rand(self.target.dim, generator=generator,
                          device=self.device)

    def _train_uniform(self, step, scalars) -> torch.Tensor:
        """The uniform draw behind the keep-mask of the step: `step` on the
        per-step path, the scalars' device row on the fused path."""
        return fused.draw_(self.state.m, kind="uniform",
                           stream=kernels.STREAM_MC_DROPOUT,
                           **self.draw_args(step, scalars))

    def _sample_z(self, u: torch.Tensor) -> torch.Tensor:
        """Bernoulli keep-mask from uniforms u: 1 where u > p_drop; biases
        forced to 1 except under 'spikymix'."""
        bern = (u > self.p_drop).float()
        if self.bias_mode == "spikymix":
            return bern
        return torch.where(self.target.is_bias, 1.0, bern)

    def _kl_coeff(self) -> torch.Tensor:
        """Per-element coefficient on (m-theta0)/sig^2/ND in the KL gradient
        and on 0.5*(m-theta0)^2/sig^2 in the KL loss."""
        one_minus_p = 1.0 - self.p_drop
        is_bias = self.target.is_bias.float()
        if self.bias_mode == "gaussian":  # weights (1-p), biases 1
            return one_minus_p * (1.0 - is_bias) + is_bias
        if self.bias_mode == "spikymix":
            return torch.full_like(is_bias, one_minus_p)
        return one_minus_p * (1.0 - is_bias)  # 'ignore': biases 0

    def _step(self, state, ns, x, y, step, scalars):
        t = self.target
        nd_size = float(t.nd_size)
        sig2 = self.prior_sig ** 2

        z = self._sample_z(self._train_uniform(step, scalars))
        theta = (z * state.m + (1.0 - z) * t.theta0).requires_grad_()
        logits, new_ns = t.forward(theta, ns, x, train=True)
        loss_nll = base.ce_loss(logits, y)
        g, = torch.autograd.grad(loss_nll, theta)
        logits = logits.detach()

        dev = state.m - t.theta0
        kl_coeff = self._kl_coeff()
        loss_kl = 0.5 * self.shard_sum(torch.sum(kl_coeff * dev * dev)) / sig2
        g_m = g * z + self.kld * kl_coeff * dev / sig2 / nd_size
        # m and buf change IN PLACE
        sgd_step(state.m, g_m, state.buf, self.lr_vec, self.cfg.momentum,
                 state.step)
        state.step += 1
        loss = loss_nll.detach() + self.kld * loss_kl / nd_size
        return state, new_ns, (loss, base.err_count(logits, y))

    def iterate(self, state):
        return state.m

    def with_iterate(self, state, vec):
        return dataclasses.replace(state, m=vec)

    def pred_state(self):
        return self.state.m

    def _predict_logits(self, m, x, generator):
        """[S, B, K]: a fresh keep-mask for each of max(nst, 1) samples."""
        out = []
        for _ in range(max(self.nst, 1)):
            z = self._sample_z(self._uniform(generator))
            theta = z * m + (1.0 - z) * self.target.theta0
            out.append(self.target.forward(theta, self.net_state, x,
                                           train=False)[0])
        return torch.stack(out)
