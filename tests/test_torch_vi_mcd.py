"""The port's VI and MC-dropout against the JAX package's, with the draws
the JAX step takes handed to the port: state and loss within rtol 1e-4,
atol 1e-5 (VI's s_ starts at 1e-6, so its atol is 1e-12; over three
steps see the test); VI's hand-written
gradients against autograd of the ELBO; the frozen uninformative biases;
`_sample_z` and `_kl_coeff` in every bias mode (exact)."""

import jax
import numpy as np
import pytest
import torch

from bayesdll_tpu_torch.methods import vi
from tests.test_torch_sgld import _close, _lockstep, _pair

VI_HP = {"prior_sig": "0.5", "kld": "1.0", "bias": "informative", "nst": "0"}
MCD_HP = {"prior_sig": "0.5", "p_drop": "0.3", "kld": "1.0", "nst": "2"}


def _hand_vi_eps(key, tr):
    eps = np.array(jax.random.normal(key, (tr.target.dim,)))
    tr._train_normal = lambda step, scalars: torch.from_numpy(eps)


def _hand_mcd_uniform(key, tr):
    kz, _ = jax.random.split(key)
    u = np.array(jax.random.uniform(kz, (tr.target.dim,)))
    tr._train_uniform = lambda step, scalars: torch.from_numpy(u)


# one step at kld 1: s_ = 1e-6 makes kld * (s/sig^2 - 1/s) / ND about -2e3
# and moves s_ to ~20, after which the next draws feed a network at very
# different weights; three steps at the smoke matrix's kld 1e-5
@pytest.mark.parametrize("steps,kld", [(1, "1.0"), (3, "1e-5")])
@pytest.mark.parametrize("bias", ["informative", "uninformative"])
def test_vi_steps_with_jax_draws_match_jax(bias, steps, kld):
    jr, tr, jl, tl = _pair("vi", dict(VI_HP, bias=bias, kld=kld),
                           momentum=0.5, lr=1e-2)
    s0 = tr.state.s_.clone()
    m0 = tr.state.m.clone()
    _lockstep(jr, tr, jl, tl, 0, steps, _hand_vi_eps)
    _close(tr.state.m, jr.state.m)
    _close(tr.state.buf_m, jr.state.buf_m)
    ts, js = tr.state.s_.numpy(), np.asarray(jr.state.s_)
    if steps == 1:
        np.testing.assert_allclose(ts, js, rtol=1e-4, atol=1e-12)
    else:
        # g_s takes (theta - m) / s with s ~ 1e-4: one ulp of m (~4e-9)
        # that the two packages' matmuls leave different after a step is
        # ~0.4% of s * eps, so a few elements of s_ move apart by that much
        rel = np.abs(ts - js) / np.abs(js)
        assert (rel <= 1e-4).mean() >= 0.99 and rel.max() < 1e-2, rel.max()
    frozen = tr.target.is_bias if bias == "uninformative" \
        else torch.zeros_like(tr.target.is_bias)
    assert torch.equal(tr.state.m[frozen], m0[frozen])
    assert torch.equal(tr.state.s_[frozen], s0[frozen])
    assert not torch.equal(tr.state.s_[~frozen], s0[~frozen])
    mean, var = tr.pred_state()
    assert float(var.min()) >= vi.S_CLAMP ** 2


def test_vi_hand_gradients_equal_autograd_of_the_elbo():
    rng = np.random.RandomState(0)
    n, sig2, kld, nd = 1000, 0.25, 0.7, 500.0
    f = lambda scale: torch.from_numpy((scale * rng.randn(n)).astype(np.float64))  # noqa: E731
    m, theta0, eps, w = f(0.1), f(0.1), f(1.0), f(1.0)
    s_ = torch.from_numpy(rng.uniform(1e-3, 0.1, n))
    m.requires_grad_()
    s_.requires_grad_()
    s = torch.clamp(s_, min=vi.S_CLAMP)
    theta = m + s * eps
    nll = torch.sum(torch.sin(theta) * w)  # any smooth data term
    kl = 0.5 * torch.sum(((m - theta0) ** 2 + s * s) / sig2
                         - torch.log(s * s / sig2) - 1.0)
    g, = torch.autograd.grad(nll, theta, retain_graph=True)
    g_m_auto, g_s_auto = torch.autograd.grad(nll + kld * kl / nd, (m, s_))
    g_m, g_s, kl_hand = vi.elbo_terms(
        g, theta.detach(), m.detach(), s.detach(), theta0,
        torch.ones(n, dtype=torch.float64), sig2=sig2, kld=kld, nd_size=nd)
    torch.testing.assert_close(g_m, g_m_auto, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(g_s, g_s_auto, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(kl_hand, kl.detach(), rtol=1e-12, atol=0)


@pytest.mark.parametrize("bias", ["gaussian", "spikymix", "ignore",
                                  "informative"])
def test_mc_dropout_steps_with_jax_draws_match_jax(bias):
    jr, tr, jl, tl = _pair("mc_dropout", dict(MCD_HP, bias=bias),
                           momentum=0.5)
    assert tr.bias_mode == jr.bias_mode  # an unknown mode is 'gaussian'
    _lockstep(jr, tr, jl, tl, 0, 1, _hand_mcd_uniform)
    _close(tr.state.m, jr.state.m)
    _close(tr.state.buf, jr.state.buf)
    np.testing.assert_array_equal(tr._kl_coeff().numpy(),
                                  np.asarray(jr._kl_coeff()))
    key = jax.random.PRNGKey(5)
    u = np.array(jax.random.uniform(key, (tr.target.dim,)))
    z = tr._sample_z(torch.from_numpy(u))
    np.testing.assert_array_equal(z.numpy(), np.asarray(jr._sample_z(key)))
    if bias == "spikymix":
        assert float(z[tr.target.is_bias].min()) == 0.0
    else:
        assert float(z[tr.target.is_bias].min()) == 1.0


def test_mc_dropout_predictive_resamples_the_mask_per_sample():
    _, tr, _, tl = _pair("mc_dropout", dict(MCD_HP, nst="3"))
    x = torch.from_numpy(next(iter(tl[2]))[0])
    gen = torch.Generator().manual_seed(0)
    la = tr._predict_logits(tr.pred_state(), x, gen)
    assert la.shape == (3, x.shape[0], 10)
    assert not torch.equal(la[0], la[1])
    res = tr.train(*tl)
    assert np.isfinite(res["nll"]) and res["test_err"] < 0.9


def test_vi_and_mc_dropout_train_end_to_end():
    """Both at the hardware smoke matrix's kld (1e-5) and p_drop (0.1)."""
    for method, hp in (("vi", dict(VI_HP, kld="1e-5", nst="2")),
                       ("mc_dropout", dict(MCD_HP, p_drop="0.1",
                                           kld="1e-5"))):
        _, tr, _, tl = _pair(method, hp, lr=2e-2)
        res = tr.train(*tl)
        assert np.isfinite(res["train_losses"]).all(), method
        assert res["test_err"] < 0.5, (method, res["test_err"])
        assert {"nll", "ece", "mce"} <= res.keys()
        assert torch.isfinite(tr.state.m).all(), method
