"""Flat layout, init and forward/backward of the PyTorch port against the
JAX package (bayesdll_tpu.core.flat / core.prior / models.mlp)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesdll_tpu.core import flat as jflat
from bayesdll_tpu.core.prior import make_flat_target as j_make_flat_target
from bayesdll_tpu.methods import base as jbase
from bayesdll_tpu.models import create_backbone as j_create_backbone
from bayesdll_tpu_torch import interop
from bayesdll_tpu_torch.core import flat as tflat
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.methods import base as tbase
from bayesdll_tpu_torch.models import create_backbone


@functools.lru_cache(maxsize=None)
def _jax_params(width, depth, seed=0):
    model, input_shape, _ = j_create_backbone("mlp_mnist", width=width,
                                              depth=depth)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1,) + input_shape), train=False)["params"]
    return jax.tree.map(np.asarray, params)


def test_full_width_layout_matches_jax():
    params = _jax_params(1000, 3)
    theta_j, _ = jflat.flatten_params(params)
    theta_t = interop.flat_from_param_dict(params)
    assert theta_t.shape[0] == 2_797_010
    np.testing.assert_array_equal(theta_t.numpy(), np.asarray(theta_j))
    spans = tflat.leaf_spans(params)
    assert spans == jflat.leaf_spans(params)
    assert spans[:4] == [("head/bias", 0, 10), ("head/kernel", 10, 10000),
                         ("layers_0/bias", 10010, 1000),
                         ("layers_0/kernel", 11010, 784000)]
    padded = interop.flat_from_param_dict(params, pad_to=1024)
    assert padded.shape[0] == 2_797_568
    assert float(padded[2_797_010:].abs().sum()) == 0.0


def test_full_width_target_counts():
    model, _, _ = create_backbone("mlp_mnist")
    target, theta, ns = make_flat_target(
        model, nd_size=100, num_classes=10,
        rng=torch.Generator().manual_seed(0), device="cpu")
    assert target.n_params == 2_797_010
    assert target.dim == theta.shape[0] == 2_797_568
    assert ns == {}
    # pad elements are inert: zero, no mask bit
    assert not bool(target.is_head[target.n_params:].any())
    assert float(theta[target.n_params:].abs().sum()) == 0.0


@pytest.mark.parametrize("width,depth", [(32, 2), (1000, 3)])
def test_masks_match_jax(width, depth):
    params = _jax_params(width, depth)
    hj, bj = jflat.path_masks(params, readout_name="head")
    ht, bt = tflat.path_masks(params, readout_name="head")
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(bt, bj)
    # and on the port's own parameter dict
    model, _, _ = create_backbone("mlp_mnist", width=width, depth=depth)
    own = model.init_params(torch.Generator().manual_seed(0))
    ho, bo = tflat.path_masks(own)
    np.testing.assert_array_equal(ho, hj)
    np.testing.assert_array_equal(bo, bj)


def test_init_distribution_matches_flax():
    model, _, _ = create_backbone("mlp_mnist")
    params = model.init_params(torch.Generator().manual_seed(0))
    for name, leaf in params.items():
        kernel = leaf["kernel"]
        fan_in = kernel.shape[0]
        want = np.sqrt((2.0 if name == "head" else 1.0) / fan_in)
        assert abs(float(kernel.std()) - want) / want < 0.05, name
        # truncated at two (pre-correction) standard deviations
        assert float(kernel.abs().max()) <= 2 * want / 0.87962566 + 1e-6
        assert float(leaf["bias"].abs().sum()) == 0.0


def test_unravel_gives_views():
    params = _jax_params(32, 2)
    theta, unravel = tflat.flatten_params(params)
    tree = unravel(theta)
    tree["head"]["bias"].add_(1.0)
    assert float(theta[:10].sub(torch.tensor(params["head"]["bias"]) + 1.0)
                 .abs().max()) == 0.0
    for (names, leaf) in tflat._leaves_with_path(params):
        node = tree
        for n in names:
            node = node[n]
        assert tuple(node.shape) == leaf.shape


def _tiny_targets(width=32, depth=2, batch=16, seed=3):
    jmodel, input_shape, _ = j_create_backbone("mlp_mnist", width=width,
                                               depth=depth)
    jtarget, jtheta, jns = j_make_flat_target(
        jmodel, input_shape, nd_size=100, num_classes=10,
        rng=jax.random.PRNGKey(seed))
    model, _, _ = create_backbone("mlp_mnist", width=width, depth=depth)
    ttarget, ttheta, _ = interop.target_from_arrays(
        np.asarray(jtheta), np.asarray(jtarget.theta0),
        np.asarray(jtarget.is_head), np.asarray(jtarget.is_bias),
        model=model, nd_size=100, num_classes=10,
        device="cpu")
    rng = np.random.RandomState(seed)
    x = rng.randn(batch, 784).astype(np.float32)
    y = rng.randint(0, 10, size=batch).astype(np.int32)
    return jtarget, jtheta, jns, ttarget, ttheta, x, y


def test_forward_and_grad_match_jax():
    jtarget, jtheta, jns, ttarget, ttheta, x, y = _tiny_targets()
    assert ttarget.dim == jtarget.dim and ttarget.n_params == jtarget.n_params

    def loss_fn(theta):
        logits, _ = jtarget.forward(theta, jns, jnp.asarray(x), train=True)
        return jbase.ce_loss(logits, jnp.asarray(y)), logits

    (jloss, jlogits), jg = jax.value_and_grad(loss_fn, has_aux=True)(jtheta)

    leaf = ttheta.detach().requires_grad_()
    tlogits, _ = ttarget.forward(leaf, {}, torch.from_numpy(x), train=True)
    tloss = tbase.ce_loss(tlogits, torch.from_numpy(y))
    tg, = torch.autograd.grad(tloss, leaf)

    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    # the padding gets no gradient
    assert float(tg[ttarget.n_params:].abs().sum()) == 0.0


def test_prior_mask_and_lr_vec_match_jax():
    jtarget, _, _, ttarget, _, _, _ = _tiny_targets()
    for mode in ("informative", "uninformative"):
        np.testing.assert_array_equal(ttarget.prior_mask(mode).numpy(),
                                      np.asarray(jtarget.prior_mask(mode)))
    np.testing.assert_array_equal(ttarget.lr_vec(0.01, 0.1).numpy(),
                                  np.asarray(jtarget.lr_vec(0.01, 0.1)))
