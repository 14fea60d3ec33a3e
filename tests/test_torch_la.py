"""The port's Laplace runner against the JAX package's: the posterior
variance of stage 2 on the same θ and batches (rtol 2e-3, as
tests/test_la.py holds its vmapped Fisher against its loop), the vmapped
Fisher against the one-example loop, the padded tail of `eval_view`, a
mini ResNet in eval mode under vmap, and both stages end to end.  Mirrors
tests/test_la.py."""

import numpy as np
import pytest
import torch

from bayesdll_tpu.data.loader import ArrayLoader as JArrayLoader
from bayesdll_tpu_torch.data.loader import ArrayLoader
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.methods.la import fisher_accumulate
from tests.test_torch_sgld import _close, _pair

LA_HP = {"prior_sig": "1.0", "Ninflate": "1.0", "bias": "informative",
         "nst": "0", "fisher_microbatch": "4"}
FISHER_TOL = dict(rtol=2e-3, atol=1e-10)


def _loop_precision(target, theta, net_state, examples, prec0):
    """The reference's one-example-at-a-time loop: prec0 + sum_i g_i^2."""
    prec = prec0.clone()
    for xi, yi in examples:
        leaf = theta.detach().clone().requires_grad_()
        logits, _ = target.forward(leaf, net_state, xi[None], train=False)
        g, = torch.autograd.grad(base.ce_loss(logits, yi[None]), leaf)
        prec += g * g
    return prec


def _examples(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 784).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("microbatch", ["4", "5"], ids=["whole", "remainder"])
@pytest.mark.parametrize("bias", ["informative", "uninformative"])
def test_variance_matches_jax_on_the_same_theta(bias, microbatch):
    jr, tr, _, _ = _pair("la", dict(LA_HP, bias=bias,
                                    fisher_microbatch=microbatch))
    jr.map_theta = jr.state.theta
    tr.map_theta = tr.state.theta
    x, y = _examples()
    jv = np.asarray(jr.estimate_variance(JArrayLoader(x, y, 16)))
    tv = tr.estimate_variance(ArrayLoader(x, y, 16))
    np.testing.assert_allclose(tv.numpy(), jv, **FISHER_TOL)


def test_vmapped_fisher_and_eval_view_match_the_loop():
    """The 40 examples once each through a shuffled, dropping train loader's
    eval_view: its padded tail (8 slots of zeros) adds nothing."""
    _, tr, _, _ = _pair("la", LA_HP)
    tr.map_theta = tr.state.theta
    x, y = _examples()
    train = ArrayLoader(x, y, 16, shuffle=True, seed=3, drop_last=True)
    assert len(train) == 2 and len(train.eval_view()) == 3
    vars_vmapped = tr.estimate_variance(train)
    ones = torch.ones(tr.target.dim)
    prec = _loop_precision(tr.target, tr.map_theta, tr.net_state,
                           zip(torch.from_numpy(x), torch.from_numpy(y).long()),
                           ones)
    np.testing.assert_allclose(vars_vmapped.numpy(), (1.0 / prec).numpy(),
                               **FISHER_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mini_resnet_fisher_under_vmap_matches_the_loop(dtype):
    """BatchNorm in eval mode, the channels_last copies and the per-leaf
    bf16 casts batch under vmap: the mini ResNet (one bottleneck per stage,
    32x32) gives the loop's Fisher, with 6 examples in microbatches of 4
    and a remainder."""
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.models.resnet import ResNet
    target, theta, ns = make_flat_target(
        ResNet((1, 1, 1, 1), 5, dtype=dtype), nd_size=64, num_classes=5,
        rng=torch.Generator().manual_seed(0), has_batch_stats=True,
        device="cpu")
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(6, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 5, 6)).long()
    valid = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 0.0])
    zeros = torch.zeros(target.dim)
    got = fisher_accumulate(target, theta, ns, zeros.clone(), x, y, valid, 4)
    want = _loop_precision(target, theta, ns, zip(x[:5], y[:5]), zeros)
    assert float(want.max()) > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-3,
                               atol=1e-6 * float(want.max()))


def test_both_stages_match_jax():
    hp = dict(LA_HP, prior_sig="0.1", fisher_microbatch="16")
    jr, tr, jl, tl = _pair("la", hp, epochs=2, lr=5e-2, momentum=0.5)
    jres = jr.train(*jl)
    tres = tr.train(*tl)
    _close(tr.map_theta, jr.map_theta)
    tv, jv = tr.post_vars.numpy(), np.asarray(jr.post_vars)
    np.testing.assert_allclose(tv, jv, **FISHER_TOL)
    assert (tv > 0).all() and tv.max() <= 0.01 + 1e-8 and tv.min() < 0.0095
    for key in ("nll", "ece", "test_loss"):
        assert abs(tres[key] - jres[key]) < 1e-3, key
    assert np.isfinite(tres["train_losses"]).all() and tres["fisher_time"] > 0
    ck = tr.extra_ckpt()
    np.testing.assert_array_equal(ck["vars"], tv)
    assert ck["map_theta"].shape == tv.shape


def test_laplace_predictive_samples_around_the_map():
    hp = dict(LA_HP, prior_sig="0.1", nst="3")
    _, tr, _, tl = _pair("la", hp)
    tr.map_theta = tr.state.theta
    tr.post_vars = torch.full_like(tr.map_theta, 1e-8)
    x = torch.from_numpy(next(iter(tl[2]))[0])
    la = tr._predict_logits(tr.pred_state(), x, torch.Generator().manual_seed(0))
    assert la.shape == (3, x.shape[0], 10) and not torch.equal(la[0], la[1])
    point = tr.target.forward(tr.map_theta, {}, x)[0]
    assert float((la.mean(0) - point).abs().max()) < 0.05
