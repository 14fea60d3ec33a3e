"""The port's ViT (models/vit.py) against the JAX package's, on two small
configurations given the JAX package's θ, and the full ViT-L/32 and
ViT-B/16 layouts from shapes only.

Configurations: `vit_tiny` (patch 8, dim 64, depth 2, heads 4, mlp 128,
32x32 inputs) and an odd one whose widths all differ (patch 8, dim 96,
depth 3, heads 3, mlp 160, 24x24 inputs: 10 tokens), so a mixed-up axis
shows.  Tolerances: fp32 logits rtol = atol = 1e-5; the flat gradient
within 1e-5 of max |g|; bf16 logits within twice JAX's own bf16-vs-fp32
gap (see test_torch_resnet.py); runner steps rtol 1e-4, atol 1e-6 per
element; remat bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import bayesdll_tpu.models.convert as jconvert
from bayesdll_tpu.config import Config as JConfig
from bayesdll_tpu.core import flat as jflat
from bayesdll_tpu.core.prior import make_flat_target as j_make_flat_target
from bayesdll_tpu.methods import base as jbase
from bayesdll_tpu.methods import get_runner_cls as j_get_runner_cls
from bayesdll_tpu.models import create_backbone as j_create_backbone
from bayesdll_tpu.models.vit import ViT as JViT
from bayesdll_tpu_torch import interop, models
from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core import flat as tflat
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.methods import base as tbase
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.models import convert, create_backbone
from bayesdll_tpu_torch.models.vit import ViT

K = 5  # classes
B = 4  # batch
ARCHS = {
    "tiny": dict(patch=8, dim=64, depth=2, heads=4, mlp_dim=128,
                 image_size=32),
    "odd": dict(patch=8, dim=96, depth=3, heads=3, mlp_dim=160,
                image_size=24),
}
TOL = dict(rtol=1e-5, atol=1e-5)


def _nested(model):
    """The port model's parameter shapes as a nested dict."""
    nested: dict = {}
    for name, p in model.named_parameters():
        *outer, leaf = name.split(".")
        node = nested
        for part in outer:
            node = node.setdefault(part, {})
        node[leaf] = p
    return nested


def _jax_target(arch, dtype="float32", **kw):
    jm = JViT(**ARCHS[arch], num_classes=K, dtype=dtype, **kw)
    side = ARCHS[arch]["image_size"]
    return j_make_flat_target(jm, (side, side, 3), nd_size=64, num_classes=K,
                              rng=jax.random.PRNGKey(0))


def _port_target(arch, jt, jth, dtype="float32", **kw):
    return interop.target_from_arrays(
        np.asarray(jth), np.asarray(jt.theta0), np.asarray(jt.is_head),
        np.asarray(jt.is_bias),
        model=ViT(**ARCHS[arch], num_classes=K, dtype=dtype, **kw),
        nd_size=64, num_classes=K, device="cpu")


def _inputs(arch, seed=1):
    side = ARCHS[arch]["image_size"]
    rng = np.random.RandomState(seed)
    return (rng.randn(B, side, side, 3).astype(np.float32),
            rng.randint(0, K, B).astype(np.int32))


@pytest.fixture(scope="module")
def jax_targets():
    return {arch: _jax_target(arch) for arch in ARCHS}


@pytest.mark.parametrize("name,num_classes,count", [
    ("vit_l_32", 1000, 306_535_400),
    ("vit_b_16", 1000, 86_567_656),
    ("vit_l_32", 37, 305_548_325),
])
def test_param_counts_from_shapes(name, num_classes, count):
    model, shape, meta = create_backbone(name, num_classes=num_classes)
    assert shape == (224, 224, 3) and not meta["has_batch_stats"]
    assert sum(p.numel() for p in model.parameters()) == count
    assert all(p.is_meta for p in model.parameters())  # nothing initialised


@pytest.mark.parametrize("name", ["vit_l_32", "vit_b_16"])
def test_full_size_spans_match_jax(name):
    """Flat layout of the full backbones, name by name, from shapes only on
    both sides: the scanned encoder's stacked leaves in sorted-key order."""
    jm, _, _ = j_create_backbone(name, num_classes=37)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)), train=False))
    model, _, _ = create_backbone(name, num_classes=37)
    spans = tflat.leaf_spans(_nested(model))
    assert spans == jflat.leaf_spans(shapes["params"])
    names = [n for n, _, _ in spans]
    assert names[:3] == ["class_token", "conv_proj/bias", "conv_proj/kernel"]
    assert names[-1] == "pos_embedding"
    assert dict((n, c) for n, _, c in spans)["layers/attention/qkv/kernel"] \
        == model.layers.attention.qkv.kernel.numel()


@pytest.mark.parametrize("arch", list(ARCHS))
def test_spans_and_masks_match_jax(jax_targets, arch):
    jt, _, _ = jax_targets[arch]
    jm = JViT(**ARCHS[arch], num_classes=K)
    side = ARCHS[arch]["image_size"]
    params = jax.tree.map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)),
        train=False)["params"])
    own = ViT(**ARCHS[arch], num_classes=K).init_params(
        torch.Generator().manual_seed(0))
    assert tflat.leaf_spans(own) == jflat.leaf_spans(params)
    hj, bj = jflat.path_masks(params)
    ht, bt = tflat.path_masks(own)
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(bt, bj)
    spans = dict((n, (s, c)) for n, s, c in tflat.leaf_spans(own))
    for leaf, is_bias in (("layers/ln_1/bias", True), ("ln/bias", True),
                          ("layers/ln_2/scale", False),
                          ("class_token", False), ("pos_embedding", False)):
        s, c = spans[leaf]
        assert bt[s:s + c].all() == is_bias and bt[s:s + c].any() == is_bias
    target, theta, _ = make_flat_target(
        ViT(**ARCHS[arch], num_classes=K), nd_size=64, num_classes=K,
        rng=torch.Generator().manual_seed(0), device="cpu")
    np.testing.assert_array_equal(target.is_head.numpy(), np.asarray(jt.is_head))
    np.testing.assert_array_equal(target.is_bias.numpy(), np.asarray(jt.is_bias))
    assert target.dim == theta.shape[0] == jt.dim
    assert target.fwd_cast == jt.fwd_cast == ""


def test_init_statistics_match_flax():
    """Each layer of a stacked kernel drawn lecun_normal with fan_in its
    own `in` (not depth * in), the patch kernel with fan_in 8*8*3, the
    head he_normal; pos_embedding normal with std 0.02, class_token and the
    biases zero, LayerNorm scale one."""
    depth = 3
    own = ViT(patch=8, dim=128, depth=depth, heads=4, mlp_dim=256,
              image_size=64, num_classes=K).init_params(
                  torch.Generator().manual_seed(0))
    lay = own["layers"]
    for kernel, fan_in in ((lay["attention"]["qkv"]["kernel"], 128),
                           (lay["attention"]["out"]["kernel"], 128),
                           (lay["mlp_dense_0"]["kernel"], 128),
                           (lay["mlp_dense_1"]["kernel"], 256)):
        assert kernel.shape[0] == depth
        want = np.sqrt(1.0 / fan_in)
        for i in range(depth):
            assert abs(float(kernel[i].std()) - want) / want < 0.05
            assert float(kernel[i].abs().max()) <= 2 * want / 0.87962566 + 1e-6
        # the layers are independent draws
        assert not torch.equal(kernel[0], kernel[1])
    for kernel, fan_in, gain in ((own["conv_proj"]["kernel"], 8 * 8 * 3, 1.0),
                                 (own["head"]["kernel"], 128, 2.0)):
        want = np.sqrt(gain / fan_in)
        assert abs(float(kernel.std()) - want) / want < 0.05
    pos = own["pos_embedding"]
    assert pos.shape == (1, 65, 128)
    assert abs(float(pos.std()) - 0.02) / 0.02 < 0.05
    assert float(pos.abs().max()) > 2 * 0.02  # not truncated
    assert float(own["class_token"].abs().sum()) == 0.0
    for leaf in (own["conv_proj"]["bias"], own["head"]["bias"],
                 lay["attention"]["qkv"]["bias"], lay["ln_1"]["bias"],
                 own["ln"]["bias"]):
        assert float(leaf.abs().sum()) == 0.0
    assert torch.equal(lay["ln_2"]["scale"], torch.ones(depth, 128))


def _jax_logits(jt, jth, x):
    return np.asarray(jax.jit(lambda th: jt.forward(th, {}, jnp.asarray(x))[0])(jth))


@pytest.mark.parametrize("gelu_approx", [False, True], ids=["erf", "tanh"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "einsum"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_fp32_logits_match_jax(arch, fused, gelu_approx):
    kw = dict(fused_attention=fused, gelu_approx=gelu_approx)
    jt, jth, _ = _jax_target(arch, **kw)
    tt, tth, _ = _port_target(arch, jt, jth, **kw)
    x, _ = _inputs(arch)
    tl, _ = tt.forward(tth, {}, torch.from_numpy(x))
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), _jax_logits(jt, jth, x), **TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_bf16_logits_match_jax_bf16(jax_targets, arch):
    """bf16 through the whole-vector cast in both packages, both fed JAX's
    fp32 θ.  XLA on the CPU keeps fp32 through a fused chain of elementwise
    ops and the port rounds every op's output, so the two bf16 forwards are
    about one gap apart: the port is held within twice JAX's own
    bf16-vs-fp32 gap of JAX's bf16 logits, and at least a quarter of that
    gap (in the mean) from the fp32 logits, which an fp32 forward fails."""
    jt32, jth, _ = jax_targets[arch]
    jt16, _, _ = _jax_target(arch, dtype="bfloat16")
    tt, tth, _ = _port_target(arch, jt16, jth, dtype="bfloat16")
    assert tt.fwd_cast == jt16.fwd_cast == "bfloat16"
    x, _ = _inputs(arch)
    j32, j16 = _jax_logits(jt32, jth, x), _jax_logits(jt16, jth, x)
    tl, _ = tt.forward(tth, {}, torch.from_numpy(x))
    assert tl.dtype == torch.float32 and torch.isfinite(tl).all()
    gap, diff = np.abs(j16 - j32), np.abs(tl.numpy() - j16)
    rounded = np.abs(tl.numpy() - j32)
    assert gap.max() > 0  # JAX's bf16 forward did round
    assert rounded.mean() >= 0.25 * gap.mean(), (rounded.mean(), gap.mean())
    assert diff.max() <= 2 * gap.max(), (diff.max(), gap.max())
    assert diff.mean() <= 2 * gap.mean(), (diff.mean(), gap.mean())


def _port_grad(tt, tth, x, y):
    leaf = tth.detach().clone().requires_grad_()
    logits, _ = tt.forward(leaf, {}, torch.from_numpy(x), train=True)
    loss = tbase.ce_loss(logits, torch.from_numpy(y))
    g, = torch.autograd.grad(loss, leaf)
    return loss.detach(), g


@pytest.mark.parametrize("arch", list(ARCHS))
def test_gradient_matches_jax(jax_targets, arch):
    jt, jth, _ = jax_targets[arch]
    tt, tth, _ = _port_target(arch, jt, jth)
    x, y = _inputs(arch)

    def loss_fn(theta):
        logits, _ = jt.forward(theta, {}, jnp.asarray(x), train=True)
        return jbase.ce_loss(logits, jnp.asarray(y))

    jg = np.asarray(jax.jit(jax.grad(loss_fn))(jth))
    _, tg = _port_grad(tt, tth, x, y)
    scale = np.abs(jg).max()
    assert np.abs(tg.numpy() - jg).max() <= 1e-5 * scale
    assert float(tg[tt.n_params:].abs().sum()) == 0.0  # padding


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["", "dots", "names"],
                         ids=["full", "dots", "names"])
def test_remat_keeps_loss_and_gradient(jax_targets, policy, dtype):
    """Each remat policy recomputes what it does not save, with the same
    operations on the same values: the loss and the gradient are those of
    the run with no remat, bit for bit."""
    jt, jth, _ = jax_targets["odd"]
    x, y = _inputs("odd")
    plain = _port_grad(*_port_target("odd", jt, jth, dtype=dtype)[:2], x, y)
    remat = _port_grad(*_port_target("odd", jt, jth, dtype=dtype, remat=True,
                                     remat_policy=policy)[:2], x, y)
    assert torch.equal(plain[0], remat[0])
    assert torch.equal(plain[1], remat[1])


class _CountOps(TorchDispatchMode):
    """Counts the ATen ops that run while it is active."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def _backward_ops(arch, **kw):
    target, theta, _ = make_flat_target(
        ViT(**ARCHS[arch], num_classes=K, **kw), nd_size=64, num_classes=K,
        rng=torch.Generator().manual_seed(0), device="cpu")
    x, y = _inputs(arch)
    leaf = theta.requires_grad_()
    loss = tbase.ce_loss(target.forward(leaf, {}, torch.from_numpy(x),
                                        train=True)[0], torch.from_numpy(y))
    with _CountOps() as count:
        torch.autograd.grad(loss, leaf)
    return count.n


@pytest.mark.parametrize("policy,extra_mm,attention", [
    ("", None, True), ("dots", 0, False), ("names", 1, False)],
    ids=["full", "dots", "names"])
def test_remat_policy_recomputes_what_jax_does(policy, extra_mm, attention):
    """The products the backward pass runs again, per block: full remat
    recomputes the attention core and at least the three products before
    the last; "dots" no product; "names" the out-projection alone, as
    JAX's save_only_these_names("qkv", "attn_out", "mlp_hidden") does."""
    depth = ARCHS["odd"]["depth"]
    base = _backward_ops("odd")
    ops = _backward_ops("odd", remat=True, remat_policy=policy)
    extra = ops.get("mm", 0) - base.get("mm", 0)
    if extra_mm is None:
        assert extra >= 3 * depth
    else:
        assert extra == extra_mm * depth
    recomputed = sum(n for k, n in ops.items()
                     if "scaled_dot_product" in k and "backward" not in k)
    assert recomputed == (depth if attention else 0)
    assert ops.get("native_layer_norm", 0) == 2 * depth  # LN is recomputed


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        ViT(**ARCHS["tiny"], remat=True, remat_policy="everything")


HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.0", "thin": "1",
      "bias": "informative", "nst": "0", "momentum_decay": "0.05"}


def test_five_runner_steps_match_jax(jax_targets):
    """Five cSGHMC steps of vit_tiny through both runners from JAX's θ at
    nd = 0: θ and v agree element for element."""
    jt, jth, _ = jax_targets["tiny"]
    tt, tth, _ = _port_target("tiny", jt, jth)
    kw = dict(method="csghmc", hparams=dict(HP), dataset="synthetic",
              backbone="vit_tiny", epochs=1, batch_size=B, lr=1e-2,
              num_cycles=1, seed=0)
    jr = j_get_runner_cls("csghmc")(jt, jth, {}, JConfig(**kw))
    tr = get_runner_cls("csghmc")(tt, tth, {}, Config(device="cpu", **kw))
    jr._ensure_sched(5)
    tr._ensure_sched(5)
    rng = np.random.RandomState(2)
    for _ in range(5):
        x = rng.randn(B, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, K, B).astype(np.int32)
        sc = jr.step_scalars(0)
        assert tr.step_scalars(0) == sc
        key = jax.random.fold_in(jr.train_key, jr.bi)
        jr.state, jr.net_state, (jloss, _) = jr._jit_step(
            jr.target, jr.state, jr.net_state, jnp.asarray(x),
            jnp.asarray(y), key, sc)
        jr.bi += 1
        tloss, _ = tr._one_step(0, x, y)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    walked = np.abs(np.asarray(jr.state.theta) - np.asarray(jth)).max()
    assert walked > 1e-4
    for name in ("theta", "v"):
        np.testing.assert_allclose(getattr(tr.state, name).numpy(),
                                   np.asarray(getattr(jr.state, name)),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# ---- the ViT half of models/convert.py -------------------------------------

def _torchvision_vit_state_dict(arch="tiny", num_classes=1000, seed=0):
    """Random weights under torchvision's ViT key names and layouts."""
    a = ARCHS[arch]
    d, m = a["dim"], a["mlp_dim"]
    t = (a["image_size"] // a["patch"]) ** 2 + 1
    rng = np.random.RandomState(seed)

    def r(*shape):
        return rng.randn(*shape).astype(np.float32)

    sd = {"conv_proj.weight": r(d, 3, a["patch"], a["patch"]),
          "conv_proj.bias": r(d), "class_token": r(1, 1, d),
          "encoder.pos_embedding": r(1, t, d),
          "encoder.ln.weight": r(d), "encoder.ln.bias": r(d),
          "heads.head.weight": r(num_classes, d),
          "heads.head.bias": r(num_classes)}
    for i in range(a["depth"]):
        p = f"encoder.layers.encoder_layer_{i}"
        sd.update({f"{p}.ln_1.weight": r(d), f"{p}.ln_1.bias": r(d),
                   f"{p}.self_attention.in_proj_weight": r(3 * d, d),
                   f"{p}.self_attention.in_proj_bias": r(3 * d),
                   f"{p}.self_attention.out_proj.weight": r(d, d),
                   f"{p}.self_attention.out_proj.bias": r(d),
                   f"{p}.ln_2.weight": r(d), f"{p}.ln_2.bias": r(d),
                   f"{p}.mlp.0.weight": r(m, d), f"{p}.mlp.0.bias": r(m),
                   f"{p}.mlp.3.weight": r(d, m), f"{p}.mlp.3.bias": r(d)})
    return sd


def _assert_trees_equal(t, j):
    assert t.keys() == j.keys()
    for k in t:
        if isinstance(t[k], dict):
            _assert_trees_equal(t[k], j[k])
        else:
            np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]),
                                          err_msg=k)


@pytest.mark.parametrize("zero_head,num_classes", [
    (True, K), (False, 1000), (False, K)])
def test_convert_matches_jax(zero_head, num_classes):
    sd = _torchvision_vit_state_dict("odd")
    a = ARCHS["odd"]
    tp, ts = convert.vit_params_from_torch(sd, a["depth"], a["dim"],
                                           num_classes, zero_head)
    jp, js = jconvert.vit_params_from_torch(sd, a["depth"], a["dim"],
                                            num_classes, zero_head)
    assert ts == {} and js == {}
    _assert_trees_equal(tp, jax.tree.map(np.asarray, jp))
    assert tp["layers"]["attention"]["qkv"]["kernel"].shape == (
        a["depth"], a["dim"], 3 * a["dim"])
    head_zero = not np.any(tp["head"]["kernel"])
    assert head_zero == (zero_head or num_classes != 1000)


def test_converted_weights_give_jax_logits():
    """The converted tree, flattened, through the port's forward gives the
    JAX package's logits from its own conversion."""
    sd = _torchvision_vit_state_dict("odd", num_classes=K)
    a = ARCHS["odd"]
    tp, _ = convert.vit_params_from_torch(sd, a["depth"], a["dim"], K, False)
    jp, _ = jconvert.vit_params_from_torch(sd, a["depth"], a["dim"], K, False)
    x, _ = _inputs("odd")
    jl = np.asarray(JViT(**a, num_classes=K).apply({"params": jp},
                                                   jnp.asarray(x)))
    theta = tflat.flatten_params(tp)[0]
    model = ViT(**a, num_classes=K)
    target = interop.target_from_arrays(
        theta.numpy(), np.zeros(theta.shape[0], np.float32),
        np.zeros(theta.shape[0], bool), np.zeros(theta.shape[0], bool),
        model=model, nd_size=64, num_classes=K, device="cpu")[0]
    tl, _ = target.forward(theta, {}, torch.from_numpy(x))
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-4, atol=1e-4)


@pytest.fixture()
def vit_file(tmp_path, monkeypatch):
    """A saved vit_tiny state_dict that both packages' conversions know."""
    path = tmp_path / "vit_tiny.pth"
    torch.save({k: torch.from_numpy(v) for k, v in
                _torchvision_vit_state_dict("tiny").items()}, path)
    arch = dict(kind="vit", depth=ARCHS["tiny"]["depth"],
                dim=ARCHS["tiny"]["dim"])
    monkeypatch.setitem(convert._ARCH, "vit_tiny", arch)
    monkeypatch.setattr(jconvert, "_ARCH", dict(jconvert._ARCH, vit_tiny=arch))
    return str(path)


def test_pretrained_prior_and_workhorse_match_jax(vit_file):
    jt, jth, _ = j_make_flat_target(
        JViT(**ARCHS["tiny"], num_classes=K), (32, 32, 3), nd_size=64,
        num_classes=K, rng=jax.random.PRNGKey(0), pad_to=1)
    tprior = convert.load_pretrained_params(vit_file, "vit_tiny", K)
    jprior = jconvert.load_pretrained_params(vit_file, "vit_tiny", K)
    theta0 = tflat.flatten_params(tprior)[0]
    np.testing.assert_array_equal(theta0.numpy(),
                                  np.asarray(jflat.flatten_params(jprior)[0]))
    target, _, _ = make_flat_target(
        ViT(**ARCHS["tiny"], num_classes=K), nd_size=64, num_classes=K,
        rng=torch.Generator().manual_seed(0), theta0_params=tprior,
        device="cpu")
    n = target.n_params
    theta_init = torch.cat([torch.from_numpy(np.array(jth)),
                            torch.zeros(target.dim - n)])
    tw = convert.pretrained_workhorse_theta(vit_file, "vit_tiny", target,
                                            theta_init, num_classes=K)
    jw = jconvert.pretrained_workhorse_theta(vit_file, "vit_tiny", jt, jth,
                                             num_classes=K)
    np.testing.assert_array_equal(tw[:n].numpy(), np.asarray(jw))
    assert convert.load_pretrained_batch_stats(vit_file, "vit_tiny") == {} \
        == jconvert.load_pretrained_batch_stats(vit_file, "vit_tiny")


def test_cli_pretrained_vit_tiny_on_cpu(vit_file, tmp_path, monkeypatch):
    """--pretrained through the CLI on a ViT: the prior mean is the file's
    body with a zeroed head, the run starts from its body and a random
    head."""
    from bayesdll_tpu_torch.cli import demo
    built = {}
    build_all = demo.build_all

    def spy(cfg, logger, workdir=None):
        runner, loaders = build_all(cfg, logger, workdir=workdir)
        built["theta"] = runner.state.theta.clone()
        built["runner"] = runner
        return runner, loaders
    monkeypatch.setattr(demo, "build_all", spy)
    results = demo.main([
        "--method", "csghmc", "--backbone", "vit_tiny",
        "--pretrained", vit_file, "--dataset", "synthetic", "--epochs", "1",
        "--num_cycles", "1", "--batch_size", "512", "--lr", "1e-4",
        "--device", "cpu", "--log_dir", str(tmp_path),
        "--hparams", "prior_sig=1.0,nd=1.0,thin=2,nst=0"])
    assert np.isfinite(results["nll"])
    target = built["runner"].target
    n = target.n_params
    prior = tflat.flatten_params(
        convert.load_pretrained_params(vit_file, "vit_tiny", 10))[0]
    np.testing.assert_array_equal(target.theta0[:n].numpy(), prior.numpy())
    head = target.is_head[:n]
    assert float(prior[head].abs().sum()) == 0.0
    np.testing.assert_array_equal(built["theta"][:n][~head].numpy(),
                                  prior[~head].numpy())
    assert float(built["theta"][:n][head].abs().sum()) > 0
    assert list(tmp_path.glob("*/vit_tiny/*_pretr1/*/*"))


def test_cli_vit_tiny_bf16_remat_on_cpu(tmp_path, monkeypatch):
    """The ViT knobs through the CLI reach the backbone."""
    from bayesdll_tpu_torch.cli import demo
    seen = {}
    create = models.create_backbone

    def spy(name, num_classes=10, **kw):
        seen.update(kw)
        return create(name, num_classes=num_classes, **kw)
    monkeypatch.setattr(models, "create_backbone", spy)
    results = demo.main([
        "--method", "csghmc", "--backbone", "vit_tiny", "--dataset",
        "synthetic", "--epochs", "1", "--num_cycles", "1", "--batch_size",
        "512", "--compute_dtype", "bfloat16", "--remat", "--remat_policy",
        "names", "--device", "cpu", "--log_dir", str(tmp_path),
        "--hparams", "prior_sig=1.0,nd=1.0,thin=2,nst=0"])
    assert np.isfinite(results["nll"]) and "ece" in results
    assert seen == dict(dtype="bfloat16", remat=True, remat_policy="names",
                        fused_attention=True,
                        gelu_approx=False)
