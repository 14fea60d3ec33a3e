"""The half-precision cast of θ at the unravel (core/prior.py::
FlatTarget.fwd_cast) against the casts inside the model and against the
JAX package's whole-vector cast (tests/test_half_flat.py): it resolves as
the JAX package resolves it, and one cast per flat leaf gives the same
logits and gradients as a cast of each weight at its use and as JAX's one
contiguous cast, since all round the same fp32 values to bf16; and every
cast leaf starts 16-byte aligned, wherever θ's offsets put it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesdll_tpu.core.prior import make_flat_target as j_make_flat_target
from bayesdll_tpu.models import create_backbone as j_create_backbone
from bayesdll_tpu_torch import interop
from bayesdll_tpu_torch.core import flat as tflat
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.methods import base as tbase
from bayesdll_tpu_torch.models import create_backbone

SMALL = {"mlp_mnist": dict(width=32, depth=2), "vit_tiny": {},
         "resnet50": {}, "cnn_mnist": {}}


def _port(name="mlp_mnist", pad_to=1, dtype="bfloat16", num_classes=10):
    model, _, meta = create_backbone(name, num_classes=num_classes,
                                     dtype=dtype, **SMALL[name])
    return make_flat_target(model, nd_size=512, num_classes=num_classes,
                            rng=torch.Generator().manual_seed(0),
                            pad_to=pad_to, device="cpu",
                            has_batch_stats=meta["has_batch_stats"])


@pytest.mark.parametrize("name,dtype,want", [
    ("mlp_mnist", "bfloat16", "bfloat16"),
    ("mlp_mnist", "float32", ""),
    ("vit_tiny", "float32", ""),
    ("vit_tiny", "bfloat16", "bfloat16"),
    ("cnn_mnist", "bfloat16", "bfloat16"),
    ("resnet50", "bfloat16", ""),
])
def test_auto_fwd_cast_resolution_matches_jax(name, dtype, want):
    model, _, _ = create_backbone(name, num_classes=10, dtype=dtype,
                                  **SMALL[name])
    if name == "resnet50":  # shapes only on both sides: no 25M-value init
        jm, _, _ = j_create_backbone(name, num_classes=10, dtype=dtype)
        assert jm.prefer_half_flat is False
        assert model.prefer_half_flat is False
        from bayesdll_tpu_torch.core.prior import auto_fwd_cast
        assert auto_fwd_cast(model) == want
        return
    target, _, _ = _port(name, dtype=dtype)
    jm, shape, _ = j_create_backbone(name, num_classes=10, dtype=dtype,
                                     **SMALL[name])
    jt, _, _ = j_make_flat_target(jm, shape, nd_size=512, num_classes=10,
                                  rng=jax.random.PRNGKey(0))
    assert target.fwd_cast == jt.fwd_cast == want


def _grad(target, theta, x, y):
    leaf = theta.detach().clone().requires_grad_()
    logits, _ = target.forward(leaf, {}, x, train=True)
    g, = torch.autograd.grad(tbase.ce_loss(logits, y), leaf)
    return logits.detach(), g


def _batch(name, seed=1):
    rng = np.random.RandomState(seed)
    shape = (784,) if name == "mlp_mnist" else (32, 32, 3)
    return (torch.from_numpy(rng.randn(8, *shape).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 10, 8)))


@pytest.mark.parametrize("name", ["mlp_mnist", "vit_tiny"])
def test_cast_at_unravel_matches_casts_at_use(name):
    """Logits and the fp32 gradient, with the cast at the unravel and with
    a cast of each weight where the model uses it.  The MLP's matrix
    products see the same bf16 values either way, so the two agree to
    fp32 rounding, as in the JAX package.  The ViT's LayerNorm takes bf16
    leaves in one and fp32 leaves in the other, so its gradients differ by
    bf16 rounding, and that propagates: there the cast at the unravel is
    held to be as close to the fp32 gradient as the casts at use, within a
    factor 2 in the max and the mean."""
    t_on, theta, _ = _port(name)
    t_off = dataclasses.replace(t_on, fwd_cast="")
    assert t_on.fwd_cast == "bfloat16"
    x, y = _batch(name)
    l_on, g_on = _grad(t_on, theta, x, y)
    l_off, g_off = _grad(t_off, theta, x, y)
    assert l_on.dtype == g_on.dtype == torch.float32
    np.testing.assert_allclose(l_on.numpy(), l_off.numpy(), rtol=1e-6,
                               atol=1e-6)
    if name == "mlp_mnist":
        np.testing.assert_allclose(g_on.numpy(), g_off.numpy(), rtol=1e-5,
                                   atol=1e-7)
        return
    t32, _, _ = _port(name, dtype="float32")
    _, g32 = _grad(t32, theta, x, y)
    on, off = (g_on - g32).abs(), (g_off - g32).abs()
    assert float(off.max()) > 0
    assert float(on.max()) <= 2 * float(off.max())
    assert float(on.mean()) <= 2 * float(off.mean())


def test_mlp_bf16_matches_jax_bf16():
    """The MLP's bf16 forward, both packages on JAX's θ through the
    whole-vector cast: within half of JAX's bf16-vs-fp32 gap in the max and
    the mean, a bound that an fp32 forward, one whole gap away, fails."""
    out = {}
    for dt in ("float32", "bfloat16"):
        jm, shape, _ = j_create_backbone("mlp_mnist", num_classes=10, dtype=dt,
                                         width=32, depth=2)
        out[dt] = j_make_flat_target(jm, shape, nd_size=512, num_classes=10,
                                     rng=jax.random.PRNGKey(0))
    jt16, jth, _ = out["bfloat16"]
    model, _, _ = create_backbone("mlp_mnist", dtype="bfloat16", width=32,
                                  depth=2)
    tt, tth, _ = interop.target_from_arrays(
        np.asarray(jth), np.asarray(jt16.theta0), np.asarray(jt16.is_head),
        np.asarray(jt16.is_bias), model=model, nd_size=512, num_classes=10,
        device="cpu")
    assert tt.fwd_cast == "bfloat16"
    x, _ = _batch("mlp_mnist")
    j16 = np.asarray(jt16.forward(jth, {}, jnp.asarray(x.numpy()))[0])
    j32 = np.asarray(out["float32"][0].forward(jth, {},
                                               jnp.asarray(x.numpy()))[0])
    tl, _ = tt.forward(tth, {}, x)
    gap, diff = np.abs(j16 - j32), np.abs(tl.numpy() - j16)
    assert gap.max() > 0
    assert np.abs(tl.numpy() - j32).max() > 0  # the port's forward did round
    assert diff.max() <= 0.5 * gap.max(), (diff.max(), gap.max())
    assert diff.mean() <= 0.5 * gap.mean(), (diff.mean(), gap.mean())


@pytest.mark.parametrize("name", ["mlp_mnist", "vit_tiny"])
def test_padded_half_flat_matches_unpadded(name):
    t_pad, theta_pad, _ = _port(name, pad_to=1024)
    t_ref, theta, _ = _port(name)
    assert theta_pad.shape[0] % 1024 == 0 and theta_pad.shape[0] > theta.shape[0]
    x, _ = _batch(name)
    y_pad, _ = t_pad.forward(theta_pad, {}, x)
    y_ref, _ = t_ref.forward(theta, {}, x)
    assert torch.equal(y_pad, y_ref)


@pytest.mark.parametrize("name", ["mlp_mnist", "vit_tiny"])
def test_cast_leaves_equal_contiguous_cast_and_are_aligned(name):
    """Each cast leaf holds the values of JAX's one contiguous cast of θ,
    unravelled, and starts on a 16-byte boundary; with 10 classes the
    head's bias leaves the leaves after it off θ's alignment."""
    target, theta, _ = _port(name, num_classes=10)
    leaves = target.leaves(theta)
    views = tflat.dotted(target.unravel(theta.to(torch.bfloat16)))
    assert leaves.keys() == views.keys()
    for key, leaf in leaves.items():
        assert leaf.dtype == torch.bfloat16
        assert torch.equal(leaf, views[key]), key
        assert leaf.data_ptr() % 16 == 0, key
    assert any(v.data_ptr() % 16 for v in views.values())


def test_make_unravel_preserves_input_dtype():
    params = {"a": {"kernel": torch.ones(3, 4), "bias": torch.zeros(4)},
              "b": {"kernel": torch.full((2, 2), 2.0)}}
    theta, unravel = tflat.flatten_params(params)
    out = unravel(theta)
    assert all(torch.equal(out[k][n], params[k][n])
               for k in params for n in params[k])
    half = theta.to(torch.bfloat16)
    out_h = unravel(half)
    leaves = [out_h["a"]["kernel"], out_h["a"]["bias"], out_h["b"]["kernel"]]
    assert all(leaf.dtype == torch.bfloat16 for leaf in leaves)
    assert out_h["a"]["kernel"].shape == (3, 4)
    # views of the one cast vector, not copies
    assert out_h["a"]["kernel"].untyped_storage().data_ptr() \
        == half.untyped_storage().data_ptr()
