"""The Adam-SGHMC step of Adam-cSGHMC in plain float32 PyTorch.

Per step t (counted from 1), with g the batch's mean-loss gradient, T the
likelihood temperature, mu the prior mean, sigma the prior's std, N the
training-set size times Ninflate, lr the per-element step size and z
standard normal noise:

    u      = g / T + (theta - mu) / sigma^2 / N
    m      <- b1 m + (1 - b1) u
    s      <- b2 s + (1 - b2) u^2
    P      = 1 / (sqrt(s / (1 - b2^t)) + eps)
    v      <- (1 - alpha) v + lr (m / (1 - b1^t)) P + nd sqrt(2 alpha P / N) z
    theta  <- theta - lr v

(SGHMC's momentum with Adam's preconditioner, then the plain SGD step of
momentum 0 that applies lr a second time).  The noise is drawn on every
step, on the Adam stream: on a card the Philox4x32-10 normals of
`sampler.philox_normals` with stream 4; on the CPU `torch.randn` from the
generator seeded with splitmix64 of (seed, 4, step).  The moments of the
collected samples are their mean and unbiased variance (Welford).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference import sampler

ADAM_STREAM = 4


def normals(n: int, *, seed: int, step: int, device) -> torch.Tensor:
    """The Adam noise of one step on `device`."""
    if torch.device(device).type == "cuda":
        return sampler.philox_normals(n, seed=seed, step=step, device=device,
                                      stream=ADAM_STREAM)
    return torch.randn(n, generator=sampler.generator("cpu", seed,
                                                      ADAM_STREAM, step),
                       dtype=torch.float32)


@dataclasses.dataclass
class AdamState:
    m: torch.Tensor
    s: torch.Tensor
    v: torch.Tensor
    t: int = 0

    @classmethod
    def zeros(cls, like):
        return cls(torch.zeros_like(like), torch.zeros_like(like),
                   torch.zeros_like(like))


def adam_sghmc_step(theta, st: AdamState, g, lr, *, prior_mean, prior_sig,
                    n_eff, nd, alpha, beta1, beta2, eps, temperature=1.0,
                    z=None):
    """One step in place on theta and the state; z None at nd = 0."""
    u = g / temperature + (theta - prior_mean) / prior_sig ** 2 / n_eff
    adam_update(theta, st, u, lr, n_eff=n_eff, nd=nd, alpha=alpha,
                beta1=beta1, beta2=beta2, eps=eps, z=z)


def adam_update(theta, st: AdamState, u, lr, *, n_eff, nd, alpha, beta1,
                beta2, eps, z=None):
    """The step from u on, in place, in the state's dtype (theta keeps
    its own)."""
    st.t += 1
    st.m.mul_(beta1).add_((1.0 - beta1) * u)
    st.s.mul_(beta2).add_((1.0 - beta2) * u * u)
    p = 1.0 / (torch.sqrt(st.s / (1.0 - beta2 ** st.t)) + eps)
    st.v.mul_(1.0 - alpha).add_(lr * (st.m / (1.0 - beta1 ** st.t)) * p)
    if z is not None:
        st.v.add_(nd * torch.sqrt(2.0 * alpha * p / n_eff) * z)
    theta.sub_(lr * st.v)


def step_u(m_prev, m, beta1):
    """The u of a step from the first moment before and after it, in
    float64: m = b1 m_prev + (1 - b1) u."""
    return (m.double() - beta1 * m_prev.double()) / (1.0 - beta1)


def first_gradient(m1, theta0, prior_mean, *, prior_sig, n_eff, beta1,
                   temperature=1.0):
    """The data gradient of step 1 from the first moment it left: m1 =
    (1 - b1) u with u = g / T + (theta0 - mu) / sigma^2 / N, in float64."""
    u = step_u(torch.zeros_like(m1), m1, beta1)
    prior = (theta0.double() - prior_mean.double()) / prior_sig ** 2 / n_eff
    return (temperature * (u - prior)).float()


