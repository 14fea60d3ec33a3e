"""The port's cnn_mnist (models/cnn.py) against the JAX package's SmallCNN
given the JAX package's θ: layout, masks, logits and the flat gradient
(which checks the NHWC flatten before dense_0), and the CLI on the CPU.

Tolerances: logits and loss rtol = atol = 1e-5, gradient within 1e-5 of
max |g|, as the MLP's forward in tests/test_torch_flat.py (fp32, no
normalisation layers to amplify rounding).
"""

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

B = 8


@pytest.fixture(scope="module")
def pair():
    jmodel, shape, jmeta = j_create_backbone("cnn_mnist")
    jt, jth, jns = j_make_flat_target(jmodel, shape, nd_size=100,
                                      num_classes=10,
                                      rng=jax.random.PRNGKey(3))
    model, tshape, meta = create_backbone("cnn_mnist")
    assert tshape == shape and meta == jmeta
    tt, tth, tns = interop.target_from_arrays(
        np.asarray(jth), np.asarray(jt.theta0), np.asarray(jt.is_head),
        np.asarray(jt.is_bias), model=model, nd_size=100, num_classes=10,
        device="cpu")
    rng = np.random.RandomState(3)
    x = rng.randn(B, 28, 28, 1).astype(np.float32)
    y = rng.randint(0, 10, B).astype(np.int32)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jmodel.init(
        k, jnp.zeros((1,) + shape), train=False))(jax.random.PRNGKey(3))
        ["params"])
    return dict(jt=jt, jth=jth, jns=jns, tt=tt, tth=tth, tns=tns, x=x, y=y,
                params=params)


def test_layout_masks_and_count_match_jax(pair):
    params = pair["params"]
    own = create_backbone("cnn_mnist")[0].init_params(
        torch.Generator().manual_seed(0))
    assert tflat.leaf_spans(own) == jflat.leaf_spans(params)
    for t, j in zip(tflat.path_masks(own), jflat.path_masks(params)):
        np.testing.assert_array_equal(t, j)
    target, theta, ns = make_flat_target(
        create_backbone("cnn_mnist")[0], nd_size=100, num_classes=10,
        rng=torch.Generator().manual_seed(0), device="cpu")
    assert ns == {} and target.n_params == pair["jt"].n_params
    assert target.dim == pair["jt"].dim == theta.shape[0]
    # conv biases are biases, and start at zero as flax's
    spans = dict((n, (s, c)) for n, s, c in tflat.leaf_spans(own))
    s, c = spans["conv_0/bias"]
    assert target.is_bias[s:s + c].all()
    assert float(theta[s:s + c].abs().sum()) == 0.0


def test_logits_and_gradient_match_jax(pair):
    jt, jth, jns = pair["jt"], pair["jth"], pair["jns"]
    x, y = pair["x"], pair["y"]

    def loss_fn(theta):
        logits, _ = jt.forward(theta, jns, jnp.asarray(x), train=True)
        return jbase.ce_loss(logits, jnp.asarray(y)), logits

    (jloss, jlogits), jg = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jth)
    leaf = pair["tth"].detach().requires_grad_()
    tlogits, _ = pair["tt"].forward(leaf, pair["tns"], torch.from_numpy(x),
                                    train=True)
    tloss = tbase.ce_loss(tlogits, torch.from_numpy(y))
    tg, = torch.autograd.grad(tloss, leaf)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    jg = np.asarray(jg)
    assert np.abs(tg.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def test_nchw_flatten_would_not_match(pair):
    """The check above can see the flatten order: dense_0's rows taken in
    (c, h, w) order give other logits."""
    tt, tth = pair["tt"], pair["tth"]
    theta = tth.clone()
    spans = dict((n, (s, c)) for n, s, c in tflat.leaf_spans(pair["params"]))
    s, c = spans["dense_0/kernel"]
    k = theta[s:s + c].view(7, 7, 64, 256)
    theta[s:s + c] = k.permute(2, 0, 1, 3).reshape(-1)
    x = torch.from_numpy(pair["x"])
    a, _ = tt.forward(tth, {}, x)
    b, _ = tt.forward(theta, {}, x)
    assert float((a - b).abs().max()) > 1e-2


def test_cli_cnn_mnist_on_cpu(tmp_path):
    from bayesdll_tpu_torch.cli import demo
    results = demo.main([
        "--method", "csghmc", "--backbone", "cnn_mnist",
        "--dataset", "synthetic", "--epochs", "1", "--num_cycles", "1",
        "--batch_size", "256", "--lr", "1e-3", "--device", "cpu",
        "--log_dir", str(tmp_path),
        "--hparams", "prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,nst=0"])
    assert np.isfinite(results["nll"]) and "ece" in results
    assert len(results["train_errors"]) == 1
    run_dirs = list(tmp_path.glob("synthetic_*/cnn_mnist/*_pretr0/*/*"))
    assert len(run_dirs) == 1 and (run_dirs[0] / "ckpt.pkl").exists()
