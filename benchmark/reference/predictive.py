"""The GMM posterior predictive in plain float32 PyTorch.

Each cycle c left a Gaussian component N(mean_c, var_c) over the flat
vector and the likelihoods p_i of a few samples around it; its weight is
w_c = 1 / mean_i(1 / p_i), normalised over the components.  For a batch,
component c averages the predictive probabilities of nst parameter draws
theta = mean_c + sqrt(var_c) eps (the draws of component c on batch i come
in order from a generator seeded with splitmix64 of (seed, 1, c, i)):

    lp_c = logsumexp_s log_softmax(f(theta_s, x)) - log(nst)

and the mixture is the weighted sum of those log-probabilities, normalised:
mix = sum_c w_c lp_c, log p = mix - logsumexp(mix).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import sampler

EVAL_STREAM = 1


def gmm_weights(likelihoods):
    """{c: w_c} from {c: [p_i]}, normalised."""
    raw = {c: 1.0 / np.mean(1.0 / np.maximum(np.asarray(p, np.float64),
                                               1e-300))
           for c, p in likelihoods.items()}
    total = sum(raw.values())
    return {c: w / total for c, w in raw.items()}


@torch.no_grad()
def mixture_logp(forward, comps, x, *, seed: int, batch_index: int,
                 nst: int, device, draw_scale: float = 1.0):
    """[B, K] float64 log-probabilities of the mixture for batch
    `batch_index`.  comps: (weight, mean, var, component id) with mean and
    var float32 [dim] on `device`; forward(theta, x) -> logits.
    draw_scale multiplies each draw's deviation (1 is the predictive; 0
    samples every component at its mean, a planted fault)."""
    mix = None
    for w, mean, var, cid in comps:
        gen = sampler.generator(device, seed, EVAL_STREAM, cid, batch_index)
        std = torch.sqrt(var)
        lps = []
        for _ in range(nst):
            eps = torch.randn(mean.shape, generator=gen, dtype=mean.dtype,
                              device=device)
            theta = mean + (std * eps if draw_scale == 1.0
                            else draw_scale * std * eps)
            lps.append(torch.log_softmax(forward(theta, x).double(), -1))
        comp = torch.logsumexp(torch.stack(lps), 0) - math.log(nst)
        mix = w * comp if mix is None else mix + w * comp
    return mix - torch.logsumexp(mix, -1, keepdim=True)
