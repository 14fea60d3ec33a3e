"""The port's V-MoE (models/vmoe.py) against the plain fp32 reference that
the benchmark checks it with (benchmark/reference/arch/vmoe.py), on the
CPU preset `vmoe_tiny`: 32x32 inputs, patch 8 (17 tokens), width 64, 4
blocks of which 1 and 3 are MoE layers over 8 experts, top-2, capacity
factor 1.05.  The JAX package has no V-MoE: nothing here compares against
it.

Tolerances: fp32 logits rtol = atol = 1e-5 and the flat gradient within
1e-5 of max |g|, each leaf's gradient norm within 1e-5 of its own (the
same fp32 arithmetic in other orders: the port gathers a buffer and sums
each token's two gates, the reference adds expert by expert); bf16
logits within 5% of the reference's norm on the program's own routing
(every activation rounded to bf16 through four blocks: the preset reads
about 1%).  The capacity rule against a per-token loop, the expert share
against the uncut layer, the refusals, the fused path and the routing
log.  The card's tests are in tests/test_torch_vmoe_card.py.
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
from bayesdll_tpu_torch.models import create_backbone, vmoe
from bayesdll_tpu_torch.utils import profiling
from benchmark import build
from benchmark.reference import layout, precision
from benchmark.reference.arch import vmoe as ref
from tests.test_torch_multichain_runner import HPARAMS
from tests.test_torch_multichain_runner import one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

K = 5
B = 4
TINY = "vmoe_tiny"
T = 17


def ref_config(name=TINY, num_classes=K, dtype="float32", **over):
    """The reference's configuration of a registered architecture."""
    a = dict(vmoe.ARCHS[name], **over)
    return {"architecture": "vmoe", "backbone": name,
            "image_size": a["image_size"], "num_channels": 3,
            "patch_size": a["patch"], "hidden_size": a["dim"],
            "num_hidden_layers": a["depth"],
            "num_attention_heads": a["heads"],
            "intermediate_size": a["mlp_dim"],
            "moe_layers": list(a["moe_layers"]),
            "num_experts": a["num_experts"],
            "experts_held": a["experts_held"],
            "expert_offset": a.get("expert_offset", 0),
            "num_selected_experts": a["num_selected_experts"],
            "capacity_factor": a["capacity_factor"],
            "num_classes": num_classes, "compute_dtype": dtype}


def arch_model(name=TINY, num_classes=K, dtype="float32", **over):
    """A V-MoE built from a registered architecture with some of its
    settings replaced (the registry builds each as registered)."""
    return vmoe.VMoE(**dict(vmoe.ARCHS[name], **over),
                     num_classes=num_classes, dtype=dtype)


def port_target(dtype="float32"):
    model, _, _ = create_backbone(TINY, num_classes=K, dtype=dtype)
    tgt, _, ns = make_flat_target(model, nd_size=64, num_classes=K,
                                  rng=torch.Generator().manual_seed(0),
                                  device="cpu")
    return tgt, ns


def inputs(seed=1, b=B):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, 32, 32, 3, generator=g),
            torch.randint(0, K, (b,), generator=g))


def loss_grad(fn, theta, y):
    leaf = theta.clone().requires_grad_()
    logits = fn(leaf)
    g, = torch.autograd.grad(F.cross_entropy(logits, y), leaf)
    return logits.detach(), g


@pytest.fixture(scope="module")
def tiny():
    """(layout, seeded theta) of the fp32 preset."""
    lay = layout.Layout(ref_config())
    return lay, build.theta(lay, 7, "cpu")


def reference(lay, x, conf=None, **kw):
    ops = precision.Products("fp32")
    return lambda th: ref.forward(lay.unravel(th), x, conf or ref_config(),
                                  ops, **kw)


# ---- shapes and layout ------------------------------------------------------


def test_full_config_parameter_count_on_meta():
    """1,008,805,925 at 37 classes with 8 of 32 experts held (the dense
    part 202,614,821, the routers 393,216, the held experts 805,797,888);
    3,427,186,664 whole at 1000 classes (published: 3.4B); from meta
    parameters, nothing allocated."""
    model, shape, meta = create_backbone("vmoe_l_16", num_classes=37,
                                         dtype="bfloat16")
    whole = arch_model("vmoe_l_16", 1000, "bfloat16", experts_held=32)
    for m, k, held, want in ((model, 37, 8, 1_008_805_925),
                             (whole, 1000, 32, 3_427_186_664)):
        params = list(m.parameters())
        assert all(p.device.type == "meta" for p in params)
        assert sum(p.numel() for p in params) == want
        conf = ref_config("vmoe_l_16", k, experts_held=held)
        assert layout.Layout(conf).n_params == want
    assert shape == (224, 224, 3) and not meta["has_batch_stats"]
    assert layout.Layout(ref_config("vmoe_l_16", 37)).dim == 1_008_806_912


def test_benchmark_configuration_is_the_registered_one():
    conf = json.loads((ROOT / "benchmark" / "configs"
                       / "vmoe_l_16.json").read_text())
    want = ref_config("vmoe_l_16", 37, "bfloat16")
    assert {k: conf[k] for k in want} == want
    assert conf["reduced"] == ["experts_held"]
    assert conf["router_noise_std"] == 0   # the port draws no router noise


def test_flat_layout_is_the_references_leaves(tiny):
    lay, _ = tiny
    tgt, _ = port_target()
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
    assert torch.equal(tgt.is_head, lay.is_head("cpu"))
    assert theirs["moe/mlp_0/kernel"].shape == (2, 4, 64, 128)
    assert theirs["moe/router/kernel"].shape == (2, 64, 8)
    assert theirs["layers/mlp_dense_0/kernel"].shape == (2, 64, 128)


def test_initial_expert_kernels_take_their_own_fan_in():
    params = port_target()[0].module.init_params(
        torch.Generator().manual_seed(3))
    for name, fan_in in (("mlp_0", 64), ("mlp_1", 128)):
        k = params["moe"][name]["kernel"]
        assert k.std().item() == pytest.approx(1 / math.sqrt(fan_in),
                                               rel=0.05)
        assert not params["moe"][name]["bias"].any()
        assert not torch.equal(k[0, 0], k[0, 1])
    lay = layout.Layout(ref_config())
    std = {leaf.name: leaf.init_std() for leaf in lay.leaves}
    assert std["moe/mlp_1/kernel"] == pytest.approx(1 / math.sqrt(128))
    assert std["moe/router/kernel"] == pytest.approx(1 / math.sqrt(64))


# ---- the forward against the reference ---------------------------------------


@pytest.mark.parametrize("seed", [1, 3])
def test_fp32_logits_loss_and_gradient_match_the_reference(tiny, seed,
                                                           one_thread):
    """On two batches, each routed by the reference itself."""
    lay, th = tiny
    tgt, ns = port_target()
    x, y = inputs(seed)
    with vmoe.routing_log(tgt.module) as log:
        got, g = loss_grad(lambda t: tgt.forward(t, ns, x, train=True)[0],
                           th, y)
    rec = []
    want, gw = loss_grad(reference(lay, x, record=rec), th, y)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
    assert F.cross_entropy(got, y).item() == pytest.approx(
        F.cross_entropy(want, y).item(), rel=1e-6)
    assert (g - gw).abs().max() <= 1e-5 * gw.abs().max()
    for (name, s, n) in lay.groups():
        a, b = g[s:s + n].norm(), gw[s:s + n].norm()
        assert (a - b).abs() <= 1e-5 * b + 1e-12, name
    assert g[lay.n_params:].abs().max() == 0
    # the same routing, and some choices dropped or held elsewhere
    for r, (own, kept) in zip(log, rec):
        assert torch.equal(r.experts, own) and torch.equal(r.kept, kept)
    assert 0 < sum(int(r.kept.sum()) for r in log) < 2 * B * T * 2


def test_bf16_logits_near_the_reference_on_the_programs_routing(tiny,
                                                                one_thread):
    lay, th = tiny
    tgt, ns = port_target("bfloat16")
    x, _ = inputs(2)
    with torch.no_grad(), vmoe.routing_log(tgt.module) as log:
        got = tgt.forward(th, ns, x)[0]
    routing = [(r.experts, r.kept) for r in log]
    with torch.no_grad():
        want = reference(lay, x, routing=routing)(th)
    assert got.dtype == torch.float32
    assert (got - want).norm() <= 0.05 * want.norm()


def _per_token_kept(experts, cap, offset, held):
    """The capacity rule, one token-choice at a time: first choices of all
    tokens in token order, then second choices."""
    n, k = experts.shape
    kept = torch.zeros(n, k, dtype=torch.bool)
    slot = torch.full((n, k), held * cap)
    count = [0] * held
    for c in range(k):
        for t in range(n):
            e = int(experts[t, c]) - offset
            if 0 <= e < held:
                if count[e] < cap:
                    kept[t, c] = True
                    slot[t, c] = e * cap + count[e]
                count[e] += 1
    return kept, slot


@pytest.mark.parametrize("factor,offset", [(1.05, 0), (0.5, 4), (2.0, 2)])
def test_capacity_and_drops_against_a_per_token_loop(factor, offset):
    n, e, held = 68, 8, 4
    cap = vmoe.capacity(n, 2, factor, e)
    assert cap == round(2 * n * factor / e)
    assert vmoe.capacity(128 * 197, 2, 1.05, 32) == 1655
    g = torch.Generator().manual_seed(5)
    # skewed logits, so that the favoured experts overflow
    logits = torch.randn(n, e, generator=g) + torch.linspace(0, 2, e)
    gates, experts, kept, slot = vmoe.route(logits, 2, cap, offset, held)
    probs = torch.softmax(logits, -1)
    assert torch.equal(gates, probs.gather(1, experts))
    assert (experts[:, 0] == probs.argmax(-1)).all()
    want_kept, want_slot = _per_token_kept(experts, cap, offset, held)
    assert torch.equal(kept, want_kept) and torch.equal(slot, want_slot)
    assert torch.equal(kept, ref.own_kept(
        {"capacity_factor": factor, "num_selected_experts": 2,
         "num_experts": e, "experts_held": held, "expert_offset": offset},
        experts))
    mine = (experts >= offset) & (experts < offset + held)
    if factor < 1:
        assert (mine & ~kept).any()   # some held choices dropped


def test_expert_shares_add_up_to_the_whole_layer(one_thread):
    """An MoE layer of 8 experts held as [0:4] and [4:8] on two models:
    their residual branches, the residual counted once, add up to the
    uncut reference's layer."""
    g = torch.Generator().manual_seed(9)
    d, m, e, n = 64, 128, 8, 3 * T
    router = torch.randn(d, e, generator=g) / 8
    k0, b0 = torch.randn(e, d, m, generator=g) / 8, torch.randn(e, m,
                                                               generator=g)
    k1, b1 = torch.randn(e, m, d, generator=g) / 11, torch.randn(e, d,
                                                                generator=g)
    x = torch.randn(3, T, d, generator=g)
    y = F.layer_norm(x, (d,))
    parts = []
    for lo in (0, 4):
        model = arch_model(expert_offset=lo)
        hi = slice(lo, lo + 4)
        parts.append(model._moe(y, 0, (router, k0[hi], b0[hi], k1[hi],
                                       b1[hi])))
    conf = ref_config(experts_held=8)
    p = {("moe", "router", "kernel"): router[None],
         ("moe", "mlp_0", "kernel"): k0[None],
         ("moe", "mlp_0", "bias"): b0[None],
         ("moe", "mlp_1", "kernel"): k1[None],
         ("moe", "mlp_1", "bias"): b1[None]}
    whole = x + ref.moe(conf, p, 0, y.reshape(n, d),
                        precision.Products("fp32")).view(3, T, d)
    assert torch.allclose(x + parts[0] + parts[1], whole, rtol=1e-5,
                          atol=1e-5)
    assert parts[0].abs().sum() > 0 and parts[1].abs().sum() > 0


# ---- refusals ---------------------------------------------------------------


def test_laplace_tensor_parallel_remat_and_vmap_are_refused(tiny):
    with pytest.raises(ValueError, match="tensor_parallel is not supported"):
        create_backbone("vmoe_l_16", num_classes=37, tp=object())
    with pytest.raises(ValueError, match="remat is not supported"):
        create_backbone(TINY, remat=True)
    with pytest.raises(ValueError, match="not among"):
        arch_model(expert_offset=6)
    with pytest.raises(ValueError, match="Laplace"):
        _runner("la")
    tgt, ns = port_target()
    x, y = inputs(4)
    with pytest.raises(ValueError, match="torch.func"):
        la.per_example_grad_fn(tgt, ns)(tiny[1], x[0], y[0])


# ---- the runners ------------------------------------------------------------


def _runner(method, fused=False, n_train=24, workdir=None, device="cpu",
            dtype="float32", fused_attention=True):
    cfg = Config(method=method, hparams=dict(HPARAMS[method]),
                 dataset="synthetic", backbone=TINY, epochs=2, batch_size=8,
                 lr=1e-3, num_cycles=1, seed=0, val_heldout=0.25,
                 device=device, num_classes=K, fused_steps=fused,
                 compute_dtype=dtype)
    cfg.synthetic_n_train = n_train
    cfg.synthetic_n_test = 8
    *loaders, nd = prepare(cfg)
    model, _, _ = create_backbone(TINY, num_classes=K, dtype=dtype,
                                  fused_attention=fused_attention)
    tgt, th, ns = make_flat_target(model, nd_size=nd, num_classes=K,
                                   rng=torch.Generator().manual_seed(0),
                                   device=device)
    return get_runner_cls(method)(tgt, th, ns, cfg, workdir=workdir), loaders


@pytest.mark.parametrize("method", sorted(set(HPARAMS) - {"la"}))
def test_every_method_but_laplace_steps_on_the_preset(method, one_thread,
                                                      tmp_path):
    runner, (train, _, _) = _runner(method, workdir=str(tmp_path))
    if hasattr(runner, "_ensure_sched"):
        runner._ensure_sched(len(train))
    before = {k: v.clone() for k, v in vars(runner.state).items()
              if isinstance(v, torch.Tensor)}
    loss, _ = runner.train_one_epoch(0, train)
    assert math.isfinite(loss)
    assert any(not torch.equal(getattr(runner.state, k), v)
               for k, v in before.items())


def _epoch_state(fused, device="cpu", dtype="float32", n_train=56,
                 fused_attention=True):
    runner, (train, _, _) = _runner("csghmc", fused, n_train, device=device,
                                    dtype=dtype,
                                    fused_attention=fused_attention)
    runner._ensure_sched(len(train))
    runner.train_one_epoch(0, train)
    st = runner.state
    return len(train), (st.theta.clone(), st.v.clone(),
                        st.moments.mean.clone())


def test_fused_steps_are_the_per_step_steps(one_thread):
    n, per_step = _epoch_state(False)
    _, fused = _epoch_state(True)
    assert n == 5
    assert all(torch.equal(a, b) for a, b in zip(per_step, fused))


def test_cli_trains_the_preset(tmp_path, one_thread):
    from bayesdll_tpu_torch.cli import demo
    demo.main(["--method", "csghmc", "--backbone", TINY, "--num_classes",
               str(K), "--dataset", "synthetic", "--batch_size", "512",
               "--epochs", "1", "--num_cycles", "1", "--lr", "1e-3",
               "--device", "cpu", "--log_dir", str(tmp_path), "--hparams",
               "prior_sig=1.0,Ninflate=1.0,nd=1.0,thin=2,bias=informative,"
               "nst=1"])
    assert any(tmp_path.rglob("ckpt.pkl"))


# ---- the routing log, spans and counters -----------------------------------------


@pytest.fixture
def recording():
    was = profiling.enable(True)
    profiling.reset()
    yield
    profiling.enable(was)
    profiling.reset()


def test_recorded_forward_spans_and_counters(recording):
    tgt, ns = port_target("bfloat16")
    x, _ = inputs(5)
    with torch.no_grad():
        tgt.forward(tgt.theta0, ns, x)
    snap = profiling.snapshot()
    spans = snap["spans"]
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine"):
        got = [s for s in spans if s["name"] == name]
        assert [s["id"] for s in got] == [0, 1]
        assert all(spans[s["parent"]]["name"] == "forward" for s in got)
    cap = vmoe.capacity(B * T, 2, 1.05, 8)
    assert snap["counters"]["moe_tokens"] == {"moe": 2 * B * T * 2}
    assert snap["counters"]["moe_slots"] == {"moe": 2 * 4 * cap}


def test_recorded_backward_spans(recording):
    """The backward of dispatch and combine opens its spans (on the
    autograd thread where there is one)."""
    tgt, ns = port_target()
    x, y = inputs(5)
    loss_grad(lambda t: tgt.forward(t, ns, x, train=True)[0], tgt.theta0, y)
    names = [s["name"] for s in profiling.snapshot()["spans"]]
    assert names.count("moe.dispatch.bwd") == names.count(
        "moe.combine.bwd") == 2


def test_routing_log_and_recorder_off_record_nothing():
    tgt, ns = port_target()
    profiling.reset()
    x, _ = inputs()
    with torch.no_grad():
        tgt.forward(tgt.theta0, ns, x)
        with vmoe.routing_log(tgt.module) as log:
            tgt.forward(tgt.theta0, ns, x)
        tgt.forward(tgt.theta0, ns, x)
    snap = profiling.snapshot()
    assert not snap["spans"] and not snap["counters"]
    assert [r.layer for r in log] == [0, 1]
    assert all(r.experts.shape == (B * T, 2) and r.kept.dtype == torch.bool
               for r in log)
