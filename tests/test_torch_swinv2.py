"""The port's SwinV2 (models/swinv2.py) against the plain fp32 reference
that the benchmark checks it with (benchmark/reference/arch/swinv2.py),
on the CPU preset `swinv2_tiny`: 64x64 inputs, patch 4, embed 32, depths
[2, 2, 2], heads [2, 4, 8], window 8 and pretrained windows [4, 4, 2], so
a shifted stage (16^2 grid, 4 windows), a global stage (8^2) and a clipped
global stage (4^2, window 4).  The JAX package has no SwinV2: nothing here
compares against it.

Tolerances: fp32 logits rtol = atol = 1e-5 and the flat gradient (also
the vmapped per-example one against each example's) within 1e-5 of max
|g| (the same fp32 arithmetic in other orders: the port scales q^ by tau
before its product and adds the bias and the mask one after the other,
the reference scales the product); bf16 logits within 5% of the
reference's norm (every activation rounded to bf16 through six blocks:
the preset reads 1-2%).  The shift masks, the CPB coordinates, the
relative-position index and patch merging's order against hand-computed
values; the full configuration's parameter count on the meta device; the
spans and counters of a recorded forward.
"""

import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core import flat
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.methods import la
from bayesdll_tpu_torch.models import create_backbone, swinv2
from bayesdll_tpu_torch.utils import profiling
from benchmark import build
from benchmark.reference import layout, models, precision
from benchmark.reference.arch import swinv2 as ref
from tests.test_torch_multichain_runner import HPARAMS
from tests.test_torch_multichain_runner import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

K = 5
B = 3
TINY = "swinv2_tiny"


def ref_config(name, num_classes=K, dtype="float32"):
    """The reference's configuration of a registered architecture."""
    a = swinv2.ARCHS[name]
    return {"architecture": "swinv2", "backbone": name,
            "image_size": a["image_size"], "num_channels": 3,
            "patch_size": a["patch"], "embed_dim": a["embed_dim"],
            "depths": list(a["depths"]), "num_heads": list(a["heads"]),
            "window_size": a["window"],
            "pretrained_window_sizes": list(a["pretrained_windows"]),
            "mlp_ratio": a["mlp_ratio"], "num_classes": num_classes,
            "compute_dtype": dtype}


def port_target(dtype="float32", **kw):
    model, _, _ = create_backbone(TINY, num_classes=K, dtype=dtype, **kw)
    tgt, _, ns = make_flat_target(model, nd_size=64, num_classes=K,
                                  rng=torch.Generator().manual_seed(0),
                                  device="cpu")
    return tgt, ns


def inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(B, 64, 64, 3, generator=g),
            torch.randint(0, K, (B,), generator=g))


def loss_grad(fn, theta, y):
    leaf = theta.clone().requires_grad_()
    logits = fn(leaf)
    g, = torch.autograd.grad(F.cross_entropy(logits, y), leaf)
    return logits.detach(), g


@pytest.fixture(scope="module")
def tiny():
    """(target, net_state, layout, seeded theta) of the fp32 preset."""
    lay = layout.Layout(ref_config(TINY))
    tgt, ns = port_target()
    return tgt, ns, lay, build.theta(lay, 7, "cpu")


def reference_forward(lay, x):
    ops = precision.Products("fp32")
    return lambda th: models.forward(lay.unravel(th), x, ref_config(TINY),
                                     ops)


# ---- shapes, layout and masks ----------------------------------------------


def test_full_config_parameter_count_on_meta():
    """195,259,801 at 37 classes, 196,739,932 at 1000 (published: 196.7M),
    read from meta parameters: nothing is allocated."""
    for k, want in ((37, 195_259_801), (1000, 196_739_932)):
        model, shape, meta = create_backbone("swinv2_l_w24_384",
                                             num_classes=k, dtype="bfloat16")
        params = list(model.parameters())
        assert all(p.device.type == "meta" for p in params)
        assert sum(p.numel() for p in params) == want
        assert layout.Layout(ref_config("swinv2_l_w24_384", k)).n_params \
            == want
    assert shape == (384, 384, 3) and not meta["has_batch_stats"]


def test_benchmark_configuration_is_the_registered_one():
    conf = json.loads((ROOT / "benchmark" / "configs"
                       / "swinv2_l_w24_384.json").read_text())
    want = ref_config("swinv2_l_w24_384", 37, "bfloat16")
    assert {k: conf[k] for k in want} == want


def test_flat_layout_is_the_references_leaves(tiny):
    tgt, _, lay, _ = tiny
    spans = flat.leaf_spans(tgt.module.init_params(
        torch.Generator().manual_seed(0)))
    assert [(n, s) for n, _, s in spans] == \
        [(leaf.name, leaf.size) for leaf in lay.leaves]
    assert (tgt.n_params, tgt.dim) == (lay.n_params, lay.dim)
    th = torch.arange(lay.dim, dtype=torch.float32)
    ours = {"/".join(k): v for k, v in lay.unravel(th).items()}
    theirs = {k.replace(".", "/"): v
              for k, v in flat.dotted(tgt.unravel(th)).items()}
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)


def test_head_and_bias_masks(tiny):
    tgt, _, lay, _ = tiny
    assert torch.equal(tgt.is_head, lay.is_head("cpu"))
    names = {leaf.name for leaf in lay.leaves}
    want_bias = {n for n in names if n.endswith("/bias")}
    # the published model's biases: q and v, proj, the MLP, the norms' and
    # the CPB MLP's first layer; the patch convolution and the head
    assert {n.split("/", 2)[-1] for n in want_bias if "blocks" in n} == {
        "attn/q/bias", "attn/v/bias", "attn/proj/bias", "attn/cpb_0/bias",
        "mlp_0/bias", "mlp_1/bias", "norm1/bias", "norm2/bias"}
    for leaf, off in zip(lay.leaves, lay.offsets):
        part = slice(off, off + leaf.size)
        assert bool(tgt.is_bias[part].all()) == (leaf.name in want_bias)
        assert bool(tgt.is_bias[part].any()) == (leaf.name in want_bias)
        assert bool(tgt.is_head[part].all()) == leaf.name.startswith("head/")
    assert not tgt.is_bias[lay.n_params:].any()


def test_initial_weights_follow_the_published_init(tiny):
    params = tiny[0].module.init_params(torch.Generator().manual_seed(3))
    attn = params["stages_0"]["blocks"]["attn"]
    assert torch.equal(attn["logit_scale"],
                       torch.full((2, 2), math.log(10.0)))
    assert not attn["q"]["bias"].any() and not attn["v"]["bias"].any()
    assert "bias" not in attn["qkv"] and "bias" not in attn["cpb_1"]
    assert "bias" not in params["stages_0"]["merge"]["reduction"]


def test_shift_regions_and_mask():
    # the 16^2 grid rolled by 4 in windows of 8: rows (and columns) 0-7,
    # 8-11 and 12-15 are regions 0, 1, 2 of each axis
    lab = swinv2.region_labels(16, 8, 4)
    axis = [0] * 8 + [1] * 4 + [2] * 4
    assert lab.tolist() == [[3 * a + b for b in axis] for a in axis]
    mask = swinv2.shift_mask(16, 8, 4)
    assert mask.shape == (4, 64, 64)
    assert not mask[0].any()                   # top-left: one region
    # top-right window: columns 8-11 and 12-15 of rows 0-7, tokens row-major
    right = torch.tensor([c >= 4 for r in range(8) for c in range(8)])
    want = torch.where(right[:, None] == right[None, :], 0.0, -100.0)
    assert torch.equal(mask[1], want)
    assert torch.equal(mask[2], want.reshape(8, 8, 8, 8).permute(1, 0, 3, 2)
                       .reshape(64, 64))       # bottom-left: the transpose
    assert mask[3].ne(0).float().mean() == pytest.approx(1 - 4 * 16 ** 2
                                                         / 64 ** 2)
    assert torch.equal(mask, ref.region_mask(16, 8, 4, "cpu"))


def test_cpb_coordinates_and_index():
    t = swinv2.coords_table(3, 4)              # offsets -2..2, 8 d / 3
    assert t.shape == (25, 2)
    # log2(1 + 8/3) / 3 and log2(1 + 16/3) / 3
    one, two = 0.6248230393053803, 0.8876550042408097
    assert t[12].tolist() == [0.0, 0.0]
    assert t[13].tolist() == pytest.approx([0.0, one])
    assert t[7].tolist() == pytest.approx([-one, 0.0])
    assert t[0].tolist() == pytest.approx([-two, -two])
    assert t[24].tolist() == pytest.approx([two, two])
    # window 2: tokens (0,0), (0,1), (1,0), (1,1); row (dh + 1) 3 + dw + 1
    assert swinv2.relative_index(2).tolist() == [
        [4, 3, 1, 0], [5, 4, 2, 1], [7, 6, 4, 3], [8, 7, 5, 4]]


def test_patch_merging_order():
    x = torch.arange(16.0).view(1, 4, 4, 1)    # x[r, c] = 4 r + c
    out = swinv2.merge_neighbours(x)
    assert out.shape == (1, 2, 2, 4)
    assert out[0, 0, 0].tolist() == [0, 4, 1, 5]
    assert out[0, 1, 0].tolist() == [8, 12, 9, 13]
    assert out[0, 0, 1].tolist() == [2, 6, 3, 7]


# ---- the forward against the reference ---------------------------------------


def test_fp32_logits_and_gradient_match_the_reference(tiny, one_thread):
    tgt, ns, lay, th = tiny
    x, y = inputs()
    got, g = loss_grad(lambda t: tgt.forward(t, ns, x, train=True)[0], th, y)
    want, gw = loss_grad(reference_forward(lay, x), th, y)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (g - gw).abs().max() <= 1e-5 * gw.abs().max()
    assert g[lay.n_params:].abs().max() == 0


def test_bf16_logits_near_the_reference(tiny, one_thread):
    _, _, lay, th = tiny
    tgt, ns = port_target("bfloat16")
    x, _ = inputs(2)
    with torch.no_grad():
        got = tgt.forward(th, ns, x)[0]
        want = reference_forward(lay, x)(th)
    assert got.dtype == torch.float32
    assert (got - want).norm() <= 0.05 * want.norm()


def test_explicit_core_and_remat_are_the_sdpa_forward(tiny, one_thread):
    """Remat gives the window-attention core's forward bits (on the CPU
    its plain version, which tests/test_torch_window_attention.py holds to
    SDPA); an explicit core (fused_attention=False) is refused."""
    _, _, lay, th = tiny
    x, y = inputs(3)
    base, g = loss_grad(lambda t: port_target()[0].forward(t, {}, x)[0],
                        th, y)
    with pytest.raises(ValueError, match="fused_attention=False"):
        create_backbone(TINY, fused_attention=False)
    tgt, _ = port_target(remat=True)
    got, g3 = loss_grad(lambda t: tgt.forward(t, {}, x)[0], th, y)
    assert torch.equal(got, base) and torch.equal(g3, g)
    with pytest.raises(ValueError, match="remat_policy"):
        create_backbone(TINY, remat=True, remat_policy="dots")


def test_tensor_parallel_is_refused():
    with pytest.raises(ValueError, match="tensor_parallel is not supported"):
        create_backbone("swinv2_l_w24_384", num_classes=37, tp=object())
    with pytest.raises(ValueError, match="no Megatron split"):
        create_backbone(TINY, tp=object())


# ---- the runners ------------------------------------------------------------


def _runner(method, fused=False, n_train=24, workdir=None):
    cfg = Config(method=method, hparams=dict(HPARAMS[method]),
                 dataset="synthetic", backbone=TINY, epochs=2, batch_size=8,
                 lr=1e-3, num_cycles=1, seed=0, val_heldout=0.25,
                 device="cpu", num_classes=K, fused_steps=fused)
    cfg.synthetic_n_train = n_train
    cfg.synthetic_n_test = 8
    *loaders, nd = prepare(cfg)
    model, _, _ = create_backbone(TINY, num_classes=K)
    tgt, th, ns = make_flat_target(model, nd_size=nd, num_classes=K,
                                   rng=torch.Generator().manual_seed(0),
                                   device="cpu")
    return get_runner_cls(method)(tgt, th, ns, cfg, workdir=workdir), loaders


@pytest.mark.parametrize("method", sorted(HPARAMS))
def test_every_method_steps_on_the_preset(method, one_thread, tmp_path):
    runner, (train, _, _) = _runner(method, workdir=str(tmp_path))
    if hasattr(runner, "_ensure_sched"):
        runner._ensure_sched(len(train))
    before = {k: v.clone() for k, v in vars(runner.state).items()
              if isinstance(v, torch.Tensor)}
    loss, _ = runner.train_one_epoch(0, train)
    assert math.isfinite(loss)
    assert any(not torch.equal(getattr(runner.state, k), v)
               for k, v in before.items())


def test_fused_path_is_the_per_step_path(one_thread):
    out = []
    for fused in (False, True):
        runner, (train, _, _) = _runner("csghmc", fused)
        runner._ensure_sched(len(train))
        runner.train_one_epoch(0, train)
        out.append((runner.state.theta.clone(), runner.state.v.clone()))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_laplace_fisher_runs_through_vmap(tiny, one_thread):
    """The per-example gradients that Laplace's Fisher squares, vmapped over
    a batch, are each example's own gradient."""
    tgt, ns, _, th = tiny
    x, y = inputs(4)
    grad_one = la.per_example_grad_fn(tgt, ns)
    batched = torch.func.vmap(grad_one, in_dims=(None, 0, 0))(th, x, y)
    for i in range(B):
        one = grad_one(th, x[i], y[i])
        assert (batched[i] - one).abs().max() <= 1e-5 * one.abs().max()


def test_one_csghmc_step_through_the_runner_matches_the_reference():
    """The benchmark's `sample` loop on the fp32 preset: three cSGHMC steps
    through the runner's `step_loop` against the reference's steps on the
    same weights, batches, step sizes and noise."""
    from benchmark import spec
    from benchmark.loops import sample
    conf = dict(ref_config(TINY, 10), name="tiny_swinv2", batch_size=8,
                lr=1e-3, hparams={"prior_sig": "1.0", "Ninflate": "1.0",
                                  "nd": "1.0", "thin": "2",
                                  "bias": "informative",
                                  "momentum_decay": "0.05"})
    traffic = {"loop": "sample", "method": "csghmc", "train_examples": 32,
               "epochs": 1000, "num_cycles": 4,
               "proportion_exploration": 0.0, "check_steps": 3,
               "trace_epochs": 1}
    cell = spec.Cell("tiny", 1, conf, traffic, {}, [], [], {})
    loop = sample.Loop(cell, 2 ** 31 + 5, "cpu")
    loop.setup(warm=False)
    loop.free()
    got = loop.check()["numbers"]
    for name in ("loss_gap", "grad_gap", "change_gap", "welford_mean_gap"):
        assert got[name] < 1e-4, (name, got)
    assert got["welford_var_gap"] < 1e-2, got


# ---- spans and counters --------------------------------------------------------


@pytest.fixture
def recording():
    was = profiling.enable(True)
    profiling.reset()
    yield
    profiling.enable(was)
    profiling.reset()


def test_recorded_forward_spans_and_counters(recording, monkeypatch):
    tgt, ns = port_target("bfloat16")
    x, _ = inputs(5)
    handed = []
    real = swinv2.window_attention

    def core(q, k, v, bias, regions=None):
        handed.append(bias.numel() * bias.element_size() + (
            0 if regions is None else regions.numel() * 4))
        return real(q, k, v, bias, regions)
    monkeypatch.setattr(swinv2, "window_attention", core)
    with torch.no_grad():
        tgt.forward(tgt.theta0, ns, x)
    snap = profiling.snapshot()
    spans = snap["spans"]
    names = [s["name"] for s in spans]
    stages = [i for i, s in enumerate(spans) if s["name"] == "swin.stage"]
    assert [spans[i]["id"] for i in stages] == [0, 1, 2]
    assert all(spans[spans[i]["parent"]]["name"] == "forward"
               for i in stages)
    inner = {"swin.window": 12, "swin.bias": 6, "swin.attn": 6,
             "swin.merge": 2}
    for name, n in inner.items():
        assert names.count(name) == n
        assert all(spans[s["parent"]]["name"] == "swin.stage"
                   for s in spans if s["name"] == name)
    # stage 0: 4 windows x 2 heads, plain then shifted; stages 1-2: one
    # window of 4 and of 8 heads, twice each
    c = snap["counters"]
    assert c["attn_windows"] == {"plain": 8 * B, "shifted": 8 * B,
                                 "global": (2 * 4 + 2 * 8) * B}
    assert sum(c["attn_mask_bytes"].values()) == sum(handed)
    n0 = 64 * 64 * 4   # fp32 [heads, 64, 64] at window 8
    assert c["attn_mask_bytes"]["plain"] == 2 * n0
    # the shared bias and 4 windows' int32 region labels, not a [windows x
    # heads, 64, 64] bias with the mask added
    assert c["attn_mask_bytes"]["shifted"] == 2 * n0 + 4 * 64 * 4
    assert c["attn_mask_bytes"]["global"] == 2 * (4 * n0 + 8 * 16 * 16 * 4)


def test_recorder_off_records_nothing():
    tgt, ns = port_target()
    profiling.reset()
    with torch.no_grad():
        tgt.forward(tgt.theta0, ns, inputs()[0])
    snap = profiling.snapshot()
    assert not snap["spans"] and not snap["counters"]
