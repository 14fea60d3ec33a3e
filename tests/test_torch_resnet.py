"""The port's ResNet (models/resnet.py, BatchNorm state through
core/prior.py) against the JAX package's, on a mini ResNet (stage sizes
(1, 1, 1, 1), 32x32 inputs, batch 4) given the JAX package's θ and
batch_stats, and ResNet-50/101 layouts built from shapes only.

Tolerances: fp32 eval logits rtol = atol = 2e-4 as
tests/test_backbones.py holds the flax ResNet against torchvision; train
mode the same; the flat gradient within 1e-4 of max |g|; runner steps in
norm (see `_assert_same_walk`); bf16 against bf16's own error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesdll_tpu.config import Config as JConfig
from bayesdll_tpu.core import flat as jflat
from bayesdll_tpu.core.prior import make_flat_target as j_make_flat_target
from bayesdll_tpu.methods import base as jbase
from bayesdll_tpu.methods import get_runner_cls as j_get_runner_cls
from bayesdll_tpu.models import create_backbone as j_create_backbone
from bayesdll_tpu.models.resnet import ResNet as JResNet
from bayesdll_tpu_torch import interop
from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core import flat as tflat
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.methods import base as tbase
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.models import create_backbone
from bayesdll_tpu_torch.models.resnet import ResNet

STAGES = (1, 1, 1, 1)
K = 5        # classes of the mini ResNet
B = 4        # batch
HW = 32      # input side
TOL = dict(rtol=2e-4, atol=2e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _random_stats(stats, rng):
    """batch_stats with random running means and positive variances, so the
    eval-mode normalisation is not the identity."""
    if "mean" in stats:
        return {"mean": (0.5 * rng.randn(*stats["mean"].shape)).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, stats["var"].shape).astype(np.float32)}
    return {k: _random_stats(v, rng) for k, v in stats.items()}


@pytest.fixture(scope="module")
def mini():
    """JAX mini ResNet target (fp32 and bf16), the port's targets built from
    its arrays, random batch_stats, and one batch."""
    rng = np.random.RandomState(0)
    out = {}
    for dt in ("float32", "bfloat16"):
        jm = JResNet(stage_sizes=STAGES, num_classes=K, dtype=dt)
        jt, jth, jns = j_make_flat_target(
            jm, (HW, HW, 3), nd_size=64, num_classes=K,
            rng=jax.random.PRNGKey(0), has_batch_stats=True)
        out[dt] = (jm, jt, jth)
    stats = _random_stats(_np_tree(jns["batch_stats"]), rng)
    x = rng.randn(B, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, K, B).astype(np.int32)
    ports = {}
    for dt, (_, jt, jth) in out.items():
        ports[dt] = interop.target_from_arrays(
            np.asarray(jth), np.asarray(jt.theta0), np.asarray(jt.is_head),
            np.asarray(jt.is_bias), model=ResNet(STAGES, K, dtype=dt),
            nd_size=64, num_classes=K, batch_stats=stats, device="cpu")
    return dict(jax=out, port=ports, stats=stats, x=x, y=y,
                jns=_np_tree(jns))


def _jax_forward(jt, jth, stats, x, train):
    fn = jax.jit(lambda th, bs, xx: jt.forward(
        th, {"batch_stats": bs}, xx, train=train))
    logits, ns = fn(jth, stats, jnp.asarray(x))
    return np.asarray(logits), _np_tree(ns["batch_stats"])


def _assert_tree_close(t, j, **tol):
    """Port tree (tensors) against JAX tree (numpy), leaf by leaf."""
    assert t.keys() == j.keys()
    for k in t:
        if isinstance(t[k], dict):
            _assert_tree_close(t[k], j[k], **tol)
        else:
            np.testing.assert_allclose(t[k].detach().numpy(), j[k],
                                       err_msg=k, **tol)


@pytest.mark.parametrize("name,num_classes,count", [
    ("resnet101", 1000, 44_549_160),
    ("resnet50", 1000, 25_557_032),
    ("resnet101", 37, 42_575_973),
])
def test_param_counts_from_shapes(name, num_classes, count):
    model, shape, meta = create_backbone(name, num_classes=num_classes)
    assert shape == (224, 224, 3) and meta["has_batch_stats"]
    assert sum(p.numel() for p in model.parameters()) == count
    assert all(p.is_meta for p in model.parameters())  # nothing initialised


@pytest.mark.parametrize("name", ["resnet50", "resnet101"])
def test_full_size_spans_match_jax(name):
    """Flat layout of the full backbones, name by name (sorted keys put
    layer3_10 before layer3_2), from shapes only on both sides."""
    jm, _, _ = j_create_backbone(name, num_classes=37)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    model, _, _ = create_backbone(name, num_classes=37)
    nested: dict = {}
    for pname, p in model.named_parameters():
        *outer, leaf = pname.split(".")
        node = nested
        for part in outer:
            node = node.setdefault(part, {})
        node[leaf] = p
    spans = tflat.leaf_spans(nested)
    assert spans == jflat.leaf_spans(shapes["params"])
    assert sum(n for _, _, n in spans) == sum(p.numel() for p in model.parameters())
    stats = create_backbone(name)[0].init_batch_stats()
    assert (tflat.leaf_spans(stats)
            == jflat.leaf_spans(shapes["batch_stats"]))


def test_mini_spans_and_masks_match_jax(mini):
    jm, jt, _ = mini["jax"]["float32"]
    params = _np_tree(jax.jit(lambda k: jm.init(
        k, jnp.zeros((1, HW, HW, 3)), train=False))(jax.random.PRNGKey(0))
        ["params"])
    own = ResNet(STAGES, K).init_params(torch.Generator().manual_seed(0))
    assert tflat.leaf_spans(own) == jflat.leaf_spans(params)
    hj, bj = jflat.path_masks(params)
    ht, bt = tflat.path_masks(own)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(bt, bj)
    # BatchNorm scale is not a bias; its bias is
    spans = dict((n, (s, c)) for n, s, c in tflat.leaf_spans(own))
    s, c = spans["bn1/scale"]
    assert not bt[s:s + c].any()
    s, c = spans["bn1/bias"]
    assert bt[s:s + c].all()
    # and the port's own target gives JAX's padded masks
    target, theta, ns = make_flat_target(
        ResNet(STAGES, K), nd_size=64, num_classes=K,
        rng=torch.Generator().manual_seed(0), has_batch_stats=True,
        device="cpu")
    np.testing.assert_array_equal(target.is_head.numpy(), np.asarray(jt.is_head))
    np.testing.assert_array_equal(target.is_bias.numpy(), np.asarray(jt.is_bias))
    assert target.dim == theta.shape[0] == jt.dim
    _assert_tree_close(ns["batch_stats"], mini["jns"]["batch_stats"], rtol=0,
                       atol=0)


def test_init_distribution_matches_flax():
    """lecun_normal conv kernels with fan_in kh*kw*in, he_normal head, BN
    scale 1 and bias 0."""
    own = ResNet(STAGES, K).init_params(torch.Generator().manual_seed(0))
    for path, fan_in, gain in (("conv1", 7 * 7 * 3, 1.0),
                               ("layer3_0/conv2", 3 * 3 * 256, 1.0),
                               ("head", 2048, 2.0)):
        node = own
        for part in path.split("/"):
            node = node[part]
        want = np.sqrt(gain / fan_in)
        assert abs(float(node["kernel"].std()) - want) / want < 0.05, path
        assert float(node["kernel"].abs().max()) <= 2 * want / 0.87962566 + 1e-6
    assert float(own["head"]["bias"].abs().sum()) == 0.0
    assert torch.equal(own["layer2_0"]["bn3"]["scale"], torch.ones(512))
    assert float(own["layer2_0"]["bn3"]["bias"].abs().sum()) == 0.0


def test_eval_forward_matches_jax(mini):
    _, jt, jth = mini["jax"]["float32"]
    tt, tth, tns = mini["port"]["float32"]
    jl, jstats = _jax_forward(jt, jth, mini["stats"], mini["x"], train=False)
    tl, tns2 = tt.forward(tth, tns, torch.from_numpy(mini["x"]), train=False)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    assert tns2 is tns  # eval mode hands net_state back as it was


def test_train_forward_and_batch_stats_match_jax(mini):
    _, jt, jth = mini["jax"]["float32"]
    tt, tth, tns = mini["port"]["float32"]
    jl, jstats = _jax_forward(jt, jth, mini["stats"], mini["x"], train=True)
    tl, tns2 = tt.forward(tth, tns, torch.from_numpy(mini["x"]), train=True)
    np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    _assert_tree_close(tns2["batch_stats"], jstats, rtol=1e-5, atol=1e-5)
    # the running averages moved, and the given ones were not written
    _assert_tree_close(tns["batch_stats"], mini["stats"], rtol=0, atol=0)
    assert not np.allclose(tns2["batch_stats"]["bn1"]["var"].numpy(),
                           mini["stats"]["bn1"]["var"])


def test_gradient_matches_jax(mini):
    """The train-mode gradient on a batch of 8 drawn for it.  Train-mode
    BatchNorm normalises layer4 over batch x 1 x 1 values per channel,
    which turns a change of summation order (oneDNN's thread count, XLA's
    fusion) into ReLU flips where a pre-activation lies within rounding of
    0, and a flip moves its weights' gradient by its full value.  On the
    fixture's batch of 4 that happened under OMP_NUM_THREADS=1 (max error
    1.2% of max |g|).  This batch has no such pre-activation: the two
    packages agree within 2e-5 of max |g| at 1, 2, 3, 4, 6 and 8 threads,
    so the bound stays 1e-4 of max |g| and a wrong gradient fails it."""
    _, jt, jth = mini["jax"]["float32"]
    tt, tth, tns = mini["port"]["float32"]
    rng = np.random.RandomState(1)
    x = rng.randn(8, HW, HW, 3).astype(np.float32)
    y = rng.randint(0, K, 8).astype(np.int32)

    def loss_fn(theta):
        logits, _ = jt.forward(theta, {"batch_stats": mini["stats"]},
                               jnp.asarray(x), train=True)
        return jbase.ce_loss(logits, jnp.asarray(y))

    jg = np.asarray(jax.jit(jax.grad(loss_fn))(jth))
    leaf = tth.detach().requires_grad_()
    logits, _ = tt.forward(leaf, tns, torch.from_numpy(x), train=True)
    tg, = torch.autograd.grad(tbase.ce_loss(logits, torch.from_numpy(y)), leaf)
    scale = np.abs(jg).max()
    assert np.abs(tg.numpy() - jg).max() <= 1e-4 * scale
    assert float(tg[tt.n_params:].abs().sum()) == 0.0  # padding


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bf16_forward_matches_jax_bf16(mini, train):
    """bf16 logits of the two packages, both fed JAX's fp32 θ.  They cannot
    agree bit for bit: the port rounds to bf16 at every layer's output, as
    flax's dtype asks, while XLA on the CPU may keep the excess fp32
    precision between fused operations (`xla_allow_excess_precision`).  So
    the bound is bf16's own error: the port's bf16 logits lie within twice
    JAX's bf16-vs-fp32 gap of JAX's bf16 logits, in the max and in the
    mean over elements.  (Train mode normalises the last stage over 4
    values per channel, which amplifies every rounding: its gap is ten
    times the eval gap.)"""
    _, jt32, jth = mini["jax"]["float32"]
    _, jt16, _ = mini["jax"]["bfloat16"]
    tt, tth, tns = mini["port"]["bfloat16"]
    j32, _ = _jax_forward(jt32, jth, mini["stats"], mini["x"], train)
    j16, _ = _jax_forward(jt16, jth, mini["stats"], mini["x"], train)
    tl, tns2 = tt.forward(tth, tns, torch.from_numpy(mini["x"]), train=train)
    assert tl.dtype == torch.float32 and torch.isfinite(tl).all()
    gap = np.abs(j16 - j32)
    diff = np.abs(tl.numpy() - j16)
    assert gap.max() > 0  # the bf16 forward did round
    assert diff.max() <= 2 * gap.max(), (diff.max(), gap.max())
    assert diff.mean() <= 2 * gap.mean(), (diff.mean(), gap.mean())
    if train:  # the statistics stay fp32
        leaf = tns2["batch_stats"]["layer1_0"]["bn2"]["var"]
        assert leaf.dtype == torch.float32


HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.0", "burnin": "0",
      "thin": "1", "bias": "informative", "nst": "0", "momentum_decay": "0.05"}
RUN_B = 8  # the runner steps normalise layer4 over 8 values per channel


def _tree_leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _tree_leaves(t[k])]
    return [np.asarray(t.detach().numpy() if torch.is_tensor(t) else t)]


def _assert_same_walk(port, jax_end, start, what):
    """port and JAX ended at the same place, having walked from `start`.

    Train-mode BatchNorm amplifies the fp32 differences of the two
    packages' convolutions (summation order) to ~1e-5 of the activations,
    which flips the ReLU of the few activations that close to 0; each flip
    changes that element's gradient by its full value.  So the walks agree
    in norm, not element for element: the gap is within 2% of the distance
    walked, and 99% of elements agree to rtol 1e-4, atol 1e-5, as the MLP
    runners do everywhere."""
    p, j, s = (np.concatenate([x.ravel() for x in _tree_leaves(t)])
               for t in (port, jax_end, start))
    walked = np.linalg.norm(j - s)
    assert walked > 0, what
    assert np.linalg.norm(p - j) <= 2e-2 * walked, what
    close = np.abs(p - j) <= 1e-5 + 1e-4 * np.abs(j)
    assert close.mean() >= 0.99, (what, close.mean())


@pytest.mark.parametrize("method", ["csghmc", "sgld"])
def test_three_runner_steps_match_jax(mini, method):
    """Three steps through both runners from the same θ and batch_stats at
    nd = 0: θ, v and batch_stats agree, and so does the eval after them."""
    _, jt, jth = mini["jax"]["float32"]
    tt, tth, tns = mini["port"]["float32"]
    kw = dict(method=method, hparams=dict(HP), dataset="synthetic",
              backbone="resnet_mini", epochs=1, batch_size=RUN_B, lr=1e-3,
              num_cycles=1, seed=0)
    jr = j_get_runner_cls(method)(jt, jth, {"batch_stats": mini["stats"]},
                                  JConfig(**kw))
    tr = get_runner_cls(method)(tt, tth, tns, Config(device="cpu", **kw))
    if method == "csghmc":
        jr._ensure_sched(3)
        tr._ensure_sched(3)
    rng = np.random.RandomState(1)
    for step in range(3):
        x = rng.randn(RUN_B, HW, HW, 3).astype(np.float32)
        y = rng.randint(0, K, RUN_B).astype(np.int32)
        sc = jr.step_scalars(0)
        assert tr.step_scalars(0) == sc
        key = jax.random.fold_in(jr.train_key, jr.bi)
        jr.state, jr.net_state, (jloss, _) = jr._jit_step(
            jr.target, jr.state, jr.net_state, jnp.asarray(x),
            jnp.asarray(y), key, sc)
        jr.bi += 1
        tloss, _ = tr._one_step(0, x, y)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=1e-5 if step == 0 else 1e-3)
    _assert_same_walk(tr.state.theta, jr.state.theta, jth, "theta")
    if method == "csghmc":
        _assert_same_walk(tr.state.v, jr.state.v, 0 * jth, "v")
    _assert_same_walk(tr.net_state["batch_stats"],
                      jr.net_state["batch_stats"], mini["stats"],
                      "batch_stats")
    # the eval after them reads the updated running averages
    jl, _ = _jax_forward(jt, jr.state.theta,
                         _np_tree(jr.net_state["batch_stats"]), mini["x"],
                         train=False)
    tl, _ = tt.forward(tr.state.theta, tr.net_state,
                       torch.from_numpy(mini["x"]), train=False)
    assert np.isfinite(tl.numpy()).all()
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-3, atol=1e-3)


def test_checkpoint_roundtrips_batch_stats(mini, tmp_path):
    tt, tth, tns = mini["port"]["float32"]
    kw = dict(method="csghmc", hparams=dict(HP), dataset="synthetic",
              backbone="resnet_mini", epochs=1, batch_size=B, lr=1e-2,
              num_cycles=1, seed=0, device="cpu")
    tr = get_runner_cls("csghmc")(tt, tth, tns, Config(**kw),
                                  workdir=str(tmp_path))
    tr._ensure_sched(3)
    tr._one_step(0, mini["x"], mini["y"])
    path = tr.save_ckpt(0)
    fresh = get_runner_cls("csghmc")(tt, tth, tns, Config(**kw))
    assert fresh.load_ckpt(path) == 0
    assert torch.equal(fresh.state.theta, tr.state.theta)
    saved = tr.net_state["batch_stats"]
    _assert_tree_close(fresh.net_state["batch_stats"],
                       tbase.to_host(saved), rtol=0, atol=0)
