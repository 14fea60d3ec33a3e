"""SwinV2's window attention (ops/window_attention.py).

On the CPU: the plain version against `F.scaled_dot_product_attention` with
the mask added to the bias as the port's SDPA core took it ([windows x
heads, N, N], the windows folded into the heads), forward and the
gradients of q, k, v and the [heads, N, N] bias, at the blocks of
`swinv2_tiny` (shifted, plain and global windows of N 64, a global window
of N 16); the wrapper sends CPU tensors to the plain version and launches
nothing; the shapes it refuses.  fp32 throughout: the two differ in the
order of the bias and mask adds and of the softmax's sums (1e-5).

On a card (marker `card`; `python -m pytest
tests/test_torch_window_attention.py -m card -s` there): the CUDA kernels
(csrc/window_attention.cu) at the three shapes `swinv2_l_w24_384.sample`
runs (N 576 shifted with 16 windows of 6 heads, N 576 global with 24
heads, N 144 with 48 heads; d 32, batch 64, bf16), each of o, dq, dk, dv
and dBias no further from the plain version in fp32 (relative Frobenius
norm) than SDPA's memory-efficient kernel on the same bf16 inputs is
(within 1% of SDPA's gap, which is mostly the rounding of the results to
bf16 that both make); two runs bit for bit; fp32 at every head width they
take (1e-5); what they refuse; `swinv2_tiny` on the card with SDPA out of
reach against its CPU run; its fused path (graph capture and replay) bit
for bit its per-step path with the kernels' launches counted per replay,
and its remat forward and gradient bit for bit the run without remat.
The kernels' times are chip_smoke.py's phase 10.
"""

import pytest
import torch
import torch.nn.functional as F

from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.models import create_backbone, swinv2
from bayesdll_tpu_torch.ops import kernels
from bayesdll_tpu_torch.ops import window_attention as wa

# swinv2_tiny's blocks: (windows, heads, N, regions of a shifted block)
TINY_BLOCKS = {
    "shifted": (4, 2, 64, (16, 8, 4)),
    "plain": (4, 2, 64, None),
    "global": (1, 4, 64, None),
    "global_16": (1, 8, 16, None),
}
# swinv2_l_w24_384's shapes at batch 64: (windows, heads, N, regions)
CELL_SHAPES = {
    "n576_shifted": (16, 6, 576, (96, 24, 12)),
    "n576_global": (1, 24, 576, None),
    "n144_global": (1, 48, 144, None),
}
def _inputs(b, w, h, n, d, regions, dtype=torch.float32, device="cpu",
            seed=0):
    """Normalised q (times tau 10) and k, v, dO from randn, the bias 16
    sigmoid(randn) in fp32 at values that `dtype` holds (so that the
    kernels, SDPA and the fp32 reference read one bias), the regions (or
    None) as int32 labels."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)
    q = F.normalize(randn(b, w, h, n, d), dim=-1) * 10.0
    k = F.normalize(randn(b, w, h, n, d), dim=-1)
    v, do = randn(b, w, h, n, d), randn(b, w, h, n, d)
    bias = (16.0 * torch.sigmoid(randn(h, n, n))).to(dtype).float()
    lab = (swinv2.window_regions(*regions).to(device)
           if regions is not None else None)
    return [t.to(dtype) for t in (q, k, v)], bias, lab, do.to(dtype)

def _sdpa(q, k, v, bias, regions):
    """The SDPA core as the port ran it: windows folded into the heads,
    the mask added to the bias, the sum in q's dtype."""
    b, w, h, n, d = q.shape
    mask = bias[None] if regions is None else (
        bias[None] + wa.region_mask(regions)[:, None])
    mask = mask.expand(w, h, n, n).reshape(1, w * h, n, n).to(q.dtype)
    o = F.scaled_dot_product_attention(
        *(t.reshape(b, w * h, n, d) for t in (q, k, v)), attn_mask=mask,
        scale=1.0)
    return o.view(b, w, h, n, d)

def _grads(fn, qkv, bias, lab, do):
    """o and the gradients of q, k, v and bias of sum(o * do)."""
    leaves = [t.detach().clone().requires_grad_() for t in (*qkv, bias)]
    o = fn(*leaves[:3], leaves[3], lab)
    grads = torch.autograd.grad((o.float() * do.float()).sum(), leaves)
    return [o.detach(), *grads]

# ---- the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("block", sorted(TINY_BLOCKS))
def test_plain_version_is_sdpa_with_the_mask_in_the_bias(block):
    w, h, n, regions = TINY_BLOCKS[block]
    qkv, bias, lab, do = _inputs(3, w, h, n, 16, regions)
    got = _grads(wa.window_attention_plain, qkv, bias, lab, do)
    want = _grads(_sdpa, qkv, bias, lab, do)
    for name, x, y in zip(("o", "dq", "dk", "dv", "dbias"), got, want):
        assert x.shape == y.shape, name
        assert torch.allclose(x, y, rtol=1e-5, atol=1e-5), name
    assert got[4].shape == (h, n, n)

def test_cpu_tensors_take_the_plain_version():
    w, h, n, regions = TINY_BLOCKS["shifted"]
    qkv, bias, lab, do = _inputs(2, w, h, n, 16, regions)
    before = kernels.launch_counts()
    got = _grads(wa.window_attention, qkv, bias, lab, do)
    want = _grads(wa.window_attention_plain, qkv, bias, lab, do)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert kernels.launch_counts() == before
    assert set(wa.KERNELS) <= set(before)

def test_refused_shapes():
    qkv, bias, lab, _ = _inputs(2, 4, 2, 64, 16, (16, 8, 4))
    with pytest.raises(ValueError, match=r"\[H, N, N\]"):
        wa.window_attention(*qkv, bias[:1], lab)
    with pytest.raises(ValueError, match="int32"):
        wa.window_attention(*qkv, bias, lab.long())
    with pytest.raises(ValueError, match=r"\[W, N\]"):
        wa.window_attention(*qkv, bias, lab[:2])
    with pytest.raises(ValueError, match="one shape"):
        wa.window_attention(qkv[0], qkv[1][:1], qkv[2], bias, lab)
    with pytest.raises(ValueError, match="one shape"):
        wa.window_attention(qkv[0][0], qkv[1][0], qkv[2][0], bias, lab)

def test_region_mask_is_the_shift_mask():
    lab = swinv2.window_regions(16, 8, 4)
    assert lab.shape == (4, 64) and lab.dtype == torch.int32
    assert torch.equal(wa.region_mask(lab), swinv2.shift_mask(16, 8, 4))

# ---- the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")

def _gap(x, ref):
    return ((x.double() - ref.double()).norm() / ref.double().norm()).item()

def _reference_fp32(qkv, bias, lab, do, chunk=8):
    """The plain version's o and gradients in fp32, over batch chunks (the
    dBias of each chunk summed)."""
    outs = []
    for i in range(0, qkv[0].shape[0], chunk):
        part = [t[i:i + chunk].float() for t in qkv]
        outs.append(_grads(wa.window_attention_plain, part, bias, lab,
                           do[i:i + chunk].float()))
    return ([torch.cat([o[j] for o in outs]) for j in range(4)]
            + [sum(o[4] for o in outs)])

@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(CELL_SHAPES))
def test_kernels_at_the_cells_shapes(card, shape):
    from torch.nn.attention import SDPBackend, sdpa_kernel
    w, h, n, regions = CELL_SHAPES[shape]
    qkv, bias, lab, do = _inputs(64, w, h, n, 32, regions, torch.bfloat16,
                                 "cuda", seed=11)
    ref = _reference_fp32(qkv, bias, lab, do)
    before = kernels.launch_counts()
    got = _grads(wa.window_attention, qkv, bias, lab, do)
    after = kernels.launch_counts()
    assert all(after[k] == before[k] + 1 for k in wa.KERNELS)
    again = _grads(wa.window_attention, qkv, bias, lab, do)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        lib = _grads(_sdpa, qkv, bias, lab, do)
    names = ("o", "dq", "dk", "dv", "dbias")
    gaps = {nm: (_gap(x, r), _gap(y, r))
            for nm, x, y, r in zip(names, got, lib, ref)}
    print(shape, {nm: f"kernel {a:.3e} sdpa {b:.3e}"
                  for nm, (a, b) in gaps.items()})
    assert got[4].shape == (h, n, n) and got[4].dtype == torch.float32
    # both round their results to bf16, which sets most of each gap: a tie
    # is within a hundredth of it
    for nm, (kernel_gap, sdpa_gap) in gaps.items():
        assert kernel_gap <= 1.01 * sdpa_gap, (nm, kernel_gap, sdpa_gap)

@pytest.mark.card
@pytest.mark.parametrize("d", wa.HEAD_WIDTHS)
def test_fp32_at_each_head_width_on_the_card(card, d):
    """fp32 products (the kernels' IEEE path) at every head width the
    kernels take, N 144 (a ragged last tile) with the shift mask."""
    qkv, bias, lab, do = _inputs(4, 4, 3, 144, d, (24, 12, 6),
                                 torch.float32, "cuda", seed=12)
    ref = _reference_fp32(qkv, bias, lab, do)
    got = _grads(wa.window_attention, qkv, bias, lab, do)
    for x, r in zip(got, ref):
        assert _gap(x, r) < 1e-5


@pytest.mark.card
def test_refusals_on_the_card(card):
    w, h, n, regions = CELL_SHAPES["n144_global"]
    qkv, bias, lab, _ = _inputs(4, w, h, n, 32, regions, torch.float32,
                                "cuda", seed=12)
    with pytest.raises(ValueError, match="head widths"):
        wa.window_attention(*(t[..., :24] for t in qkv), bias, lab)
    with pytest.raises(ValueError, match="take q, k, v"):
        wa.window_attention(*(t.double() for t in qkv), bias, lab)
    qkv36, bias36, _, _ = _inputs(2, 1, 2, 36, 32, None, torch.bfloat16,
                                  "cuda", seed=12)
    with pytest.raises(ValueError, match="multiple of 8"):
        wa.window_attention(*qkv36, bias36)
    with pytest.raises(RuntimeError, match="torch.func"):
        torch.func.vmap(wa.window_attention, in_dims=(0, 0, 0, None, None))(
            *(t[None] for t in qkv), bias, lab)

@pytest.mark.card
def test_tiny_swinv2_on_the_card_without_sdpa(card, monkeypatch):
    def refused(*a, **kw):
        raise AssertionError("SDPA called on the SwinV2 path")
    monkeypatch.setattr(F, "scaled_dot_product_attention", refused)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(3))
    out = []
    for device in ("cpu", "cuda"):
        model, _, _ = create_backbone("swinv2_tiny", num_classes=5)
        tgt, theta, ns = make_flat_target(
            model, nd_size=64, num_classes=5,
            rng=torch.Generator().manual_seed(0), device=device)
        theta = theta.clone().requires_grad_()
        before = kernels.launch_counts()
        logits = tgt.forward(theta, ns, x.to(device))[0]
        logits.square().sum().backward()
        counts = kernels.launch_counts()
        out.append((logits.detach().cpu(),
                    {k: counts[k] - before[k] for k in wa.KERNELS}))
    assert torch.allclose(out[1][0], out[0][0], rtol=1e-4, atol=1e-4)
    assert out[0][1] == dict.fromkeys(wa.KERNELS, 0)
    assert out[1][1] == dict.fromkeys(wa.KERNELS, 6)

# tests/test_torch_multichain_runner.py's cSGHMC settings
CSGHMC_HP = {"prior_sig": "0.05", "Ninflate": "1.0", "nd": "0.001",
             "thin": "2", "bias": "informative", "nst": "2",
             "momentum_decay": "0.05"}


def _tiny_runner(fused, dtype):
    """A cSGHMC runner of swinv2_tiny on the card: 3 steps an epoch."""
    cfg = Config(method="csghmc", hparams=dict(CSGHMC_HP),
                 dataset="synthetic", backbone="swinv2_tiny", epochs=2,
                 batch_size=8, lr=1e-3, num_cycles=1, seed=0,
                 val_heldout=0.25, device="cuda", num_classes=5,
                 compute_dtype=dtype, fused_steps=fused)
    cfg.synthetic_n_train = 32
    cfg.synthetic_n_test = 8
    train, _, _, nd = prepare(cfg)
    model, _, _ = create_backbone("swinv2_tiny", num_classes=5,
                                  **cfg.backbone_kw())
    tgt, th, ns = make_flat_target(model, nd_size=nd, num_classes=5,
                                   rng=torch.Generator().manual_seed(0),
                                   device="cuda")
    return get_runner_cls("csghmc")(tgt, th, ns, cfg), train


@pytest.mark.card
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_path_and_remat_on_the_card(card, dtype):
    """The fused path captures the kernels into a CUDA graph and replays
    it: the epoch is bit for bit the per-step epoch, and each replay adds
    its launches (6 blocks, one launch of each kernel a block and step).
    Remat runs the forward kernel again in the backward: the same logits
    and gradient bits as without it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for fused in (False, True):
        runner, train = _tiny_runner(fused, dtype)
        runner._ensure_sched(len(train))
        before = kernels.launch_counts()
        runner.train_one_epoch(0, train)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        out.append((runner.state.theta.clone(), runner.state.v.clone(),
                    {k: after[k] - before[k] for k in wa.KERNELS}))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2] == dict.fromkeys(wa.KERNELS,
                                                   6 * len(train))
    x = torch.randn(4, 64, 64, 3, generator=torch.Generator().manual_seed(5))
    y = torch.tensor([0, 1, 2, 3])
    got = []
    for remat in (False, True):
        model, _, _ = create_backbone("swinv2_tiny", num_classes=5,
                                      dtype=dtype, remat=remat)
        tgt, theta, ns = make_flat_target(
            model, nd_size=64, num_classes=5,
            rng=torch.Generator().manual_seed(0), device="cuda")
        theta = theta.clone().requires_grad_()
        logits = tgt.forward(theta, ns, x.cuda())[0]
        g, = torch.autograd.grad(
            F.cross_entropy(logits.float(), y.cuda()), theta)
        got.append((logits.detach(), g))
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
