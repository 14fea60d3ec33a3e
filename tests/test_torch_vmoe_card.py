"""V-MoE (models/vmoe.py) on the card, marker `card` (skipped where there is
none): `python -m pytest tests/test_torch_vmoe_card.py -m card -q`.  This
file imports nothing from other test files, so that it runs where another
installed package takes the name `tests`.

  * bf16: five per-step steps twice, and five fused steps (captured
    graphs, replayed), bit for bit, on `vmoe_tiny` with the explicit
    attention core and cuDNN deterministic: SDPA's backward and cuDNN's
    convolution algorithms need not be, and the test holds the MoE
    layer's own determinism;
  * fp32 with TF32 off: the routing log's experts against the reference's
    own top-2 on every token whose margin between the second and third
    router logits passes 1e-4 (closer ones may round either way), on the
    program's path, and its kept flags against the reference's capacity
    rule.
"""

import pytest
import torch

from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.models import create_backbone, vmoe
from benchmark import build
from benchmark.reference import layout, precision
from benchmark.reference.arch import vmoe as ref

K = 5
TINY = "vmoe_tiny"
HPARAMS = {"prior_sig": "0.05", "Ninflate": "1.0", "nd": "0.001",
           "thin": "2", "bias": "informative", "nst": "2",
           "momentum_decay": "0.05"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return "cuda"


@pytest.fixture
def deterministic_cudnn():
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = was


def ref_config():
    a = vmoe.ARCHS[TINY]
    return {"architecture": "vmoe", "backbone": TINY,
            "image_size": a["image_size"], "num_channels": 3,
            "patch_size": a["patch"], "hidden_size": a["dim"],
            "num_hidden_layers": a["depth"],
            "num_attention_heads": a["heads"],
            "intermediate_size": a["mlp_dim"],
            "moe_layers": list(a["moe_layers"]),
            "num_experts": a["num_experts"],
            "experts_held": a["experts_held"], "expert_offset": 0,
            "num_selected_experts": a["num_selected_experts"],
            "capacity_factor": a["capacity_factor"],
            "num_classes": K,
            "compute_dtype": "float32"}


def _epoch_state(fused):
    """theta, v and the moments' mean after one bf16 epoch of five cSGHMC
    steps on the card."""
    cfg = Config(method="csghmc", hparams=dict(HPARAMS),
                 dataset="synthetic", backbone=TINY, epochs=2, batch_size=8,
                 lr=1e-3, num_cycles=1, seed=0, val_heldout=0.25,
                 device="cuda", num_classes=K, fused_steps=fused,
                 compute_dtype="bfloat16")
    cfg.synthetic_n_train = 56
    cfg.synthetic_n_test = 8
    train, _, _, nd = prepare(cfg)
    model, _, _ = create_backbone(TINY, num_classes=K, dtype="bfloat16",
                                  fused_attention=False)
    tgt, th, ns = make_flat_target(model, nd_size=nd, num_classes=K,
                                   rng=torch.Generator().manual_seed(0),
                                   device="cuda")
    runner = get_runner_cls("csghmc")(tgt, th, ns, cfg)
    runner._ensure_sched(len(train))
    runner.train_one_epoch(0, train)
    st = runner.state
    assert len(train) == 5
    return st.theta.clone(), st.v.clone(), st.moments.mean.clone()


@pytest.mark.card
def test_two_runs_and_the_fused_path_are_bitwise(cuda, deterministic_cudnn):
    a, b, c = _epoch_state(False), _epoch_state(False), _epoch_state(True)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.card
def test_fp32_routing_is_the_references_own(cuda):
    lay = layout.Layout(ref_config())
    th = build.theta(lay, 7, cuda)
    model, _, _ = create_backbone(TINY, num_classes=K)
    tgt, _, ns = make_flat_target(model, nd_size=64, num_classes=K,
                                  rng=torch.Generator().manual_seed(0),
                                  device=cuda)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(16, 32, 32, 3, generator=g).to(cuda)
    with torch.no_grad(), vmoe.routing_log(tgt.module) as log, \
            precision.fp32_products():
        tgt.forward(th, ns, x)
    logits = []
    p = lay.unravel(th)
    orig = ref.moe

    def moe_spy(c, p, j, y, ops, *a, **kw):
        logits.append(ops.mm(y, p[("moe", "router", "kernel")][j]))
        return orig(c, p, j, y, ops, *a, **kw)
    ref.moe, rec = moe_spy, []
    try:
        with torch.no_grad(), precision.fp32_products():
            ref.forward(p, x, ref_config(), precision.Products("fp32"),
                        routing=[(r.experts, r.kept) for r in log],
                        record=rec)
    finally:
        ref.moe = orig
    for r, (own, _), lg in zip(log, rec, logits):
        top3 = lg.topk(3, dim=-1).values
        clear = (top3[:, 1] - top3[:, 2]) > 1e-4
        assert clear.float().mean() > 0.9
        assert torch.equal(r.experts[clear].sort(-1).values,
                           own[clear].sort(-1).values)
        assert torch.equal(r.kept, ref.own_kept(ref_config(), r.experts))
