"""Adam-SGHMC's update as one pass (ops/fused.py::adam_sghmc_update_): the
momentum and the torch-SGD step after it.

On the card (marker `card`; `python -m pytest tests/test_torch_adam_kernel.py
-m card` there) the adam_sghmc_update kernel against the eager composition
it replaces, `adam_sghmc_momentum` on philox_draw's Adam-stream draw and
then `sgd_step`, bit for bit: both methods' forms, nd 0 and 1, temperature
1 and 0.5, torch-SGD momentum 0 and 0.9, Adam steps 1 and 7, a length that
is not a multiple of 4, shards at an offset; its normals against
philox_draw's; five fused steps against five per-step steps, one launch a
step.  On the CPU the entry runs the same plain composition, and the same
tests hold it there.
"""

import pytest
import torch

from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.core.prior import make_flat_target
from bayesdll_tpu_torch.core.sgd import sgd_step
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.methods import get_runner_cls
from bayesdll_tpu_torch.models import create_backbone
from bayesdll_tpu_torch.ops import fused, kernels

D = 4096 + 3  # a scalar tail
SEED, STEP = 2**63 + 5, 2**32 + 9  # all 64 bits of each
ADAM_KW = dict(prior_sig=0.5, n_eff=1000.0, alpha=0.05, beta1=0.9,
               beta2=0.999, eps_adam=1e-8)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return request.param


def _vectors(device, n=D, seed=0):
    gen = torch.Generator().manual_seed(seed)
    f = lambda scale: scale * torch.randn(n, generator=gen)  # noqa: E731
    vec = dict(g=f(0.1), theta=f(0.05), theta0=f(0.05), v_mom=f(1e-3),
               m=f(1e-2), v2=f(1e-3).abs(), buf=f(1e-3))
    vec["mask"] = (torch.rand(n, generator=gen) > 0.2).float()
    vec["lr"] = torch.where(torch.rand(n, generator=gen) > 0.9, 2e-3, 1e-3)
    return {k: v.to(device) for k, v in vec.items()}


def _eager(a, t, *, add_g, momentum, sgd_count, nd, temperature,
           elem0=0, total=None):
    """The composition the pass replaces, in place on `a`: the Adam-stream
    draw, adam_sghmc_momentum, then sgd_step on g + v_mom or v_mom."""
    noise = fused.draw_(a["g"], kind="normal", stream=kernels.STREAM_ADAM,
                        seed=SEED, step=STEP, elem0=elem0, total=total) \
        if nd else None
    fused.adam_sghmc_momentum(
        a["g"], a["theta"], a["theta0"], a["v_mom"], a["m"], a["v2"], t,
        a["mask"], a["lr"], nd=nd, temperature=temperature, noise=noise,
        **ADAM_KW)
    sgd_step(a["theta"], a["g"] + a["v_mom"] if add_g else a["v_mom"],
             a["buf"], a["lr"], momentum, sgd_count)


def _entry(a, t, *, add_g, momentum, sgd_count, nd, temperature,
           elem0=0, total=None):
    fused.adam_sghmc_update_(
        a["g"], a["theta"], a["theta0"], a["v_mom"], a["m"], a["v2"],
        a["buf"], t, a["mask"], a["lr"], add_g=add_g, momentum=momentum,
        sgd_count=sgd_count, seed=SEED, step=STEP, elem0=elem0, total=total,
        nd=nd, temperature=temperature, **ADAM_KW)


def _assert_equal(got, want, *, add_g, momentum):
    """Every vector bit for bit; where the entry left SGD's gradient g +
    v_mom for the eager step, it wrote it over g."""
    for k in want:
        w = want[k] + want["v_mom"] if k == "g" and add_g and momentum \
            else want[k]
        assert torch.equal(got[k], w), k


@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("temperature", [1.0, 0.5])
@pytest.mark.parametrize("nd", [0.0, 1.0])
@pytest.mark.parametrize("add_g", [True, False],
                         ids=["adam_sghmc", "adam_csghmc"])
def test_entry_equals_the_eager_composition(device, add_g, nd, temperature,
                                            momentum, t):
    """On the card the kernel's pass; on the CPU the plain versions."""
    args = dict(add_g=add_g, momentum=momentum, sgd_count=t - 1, nd=nd,
                temperature=temperature)
    want, got = _vectors(device), _vectors(device)
    _eager(want, t, **args)
    before = kernels.adam_sghmc_update.launches
    _entry(got, t, **args)
    _assert_equal(got, want, add_g=add_g, momentum=momentum)
    assert kernels.adam_sghmc_update.launches - before == \
        (device == "cuda")


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_shards_concatenate_to_the_whole_vector(device, momentum):
    """Two shards at their global offsets (elem0 0 and 2048 of a vector of
    4099) give the whole vector's bits: the noise of each shard's own
    elements."""
    args = dict(add_g=True, momentum=momentum, sgd_count=3, nd=1.0,
                temperature=1.0)
    whole, parts = _vectors(device), _vectors(device)
    _entry(whole, 4, **args)
    for lo, hi in ((0, 2048), (2048, D)):
        _entry({k: v[lo:hi] for k, v in parts.items()}, 4, elem0=lo,
               total=D, **args)
    for k in whole:
        assert torch.equal(parts[k], whole[k]), k


def test_the_normals_are_the_draws_on_the_adam_stream(device):
    """z itself: with the state zero, lr 0, eps 2^-20, alpha 1/2 and N
    2^20, P = 2^20 and the noise scale nd sqrt(2 alpha P / N) is exactly 1,
    so v_mom' = z, which is `draw_`'s normal draw on STREAM_ADAM (on the
    card philox_draw's bits)."""
    a = {k: torch.zeros(D, device=device) for k in
         ("g", "theta", "theta0", "v_mom", "m", "v2", "buf", "lr")}
    a["mask"] = torch.ones(D, device=device)
    fused.adam_sghmc_update_(
        a["g"], a["theta"], a["theta0"], a["v_mom"], a["m"], a["v2"],
        a["buf"], 3, a["mask"], a["lr"], add_g=False, momentum=0.0,
        sgd_count=2, seed=SEED, step=STEP, prior_sig=1.0, n_eff=2.0**20,
        nd=1.0, alpha=0.5, beta1=0.9, beta2=0.999, eps_adam=2.0**-20)
    z = fused.draw_(a["g"], kind="normal", stream=kernels.STREAM_ADAM,
                    seed=SEED, step=STEP)
    assert torch.equal(a["v_mom"], z)
    assert float(z.std()) == pytest.approx(1.0, abs=0.05)


def test_bias_row():
    row = kernels.bias_row(*fused.adam_bias_corrections(7, 0.9, 0.999),
                           device="cpu")
    assert row.dtype == torch.float32 and row.shape == (2,)
    assert tuple(row.tolist()) == fused.adam_bias_corrections(7, 0.9, 0.999)


ADAM_HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "0.05", "burnin": "0",
           "thin": "2", "bias": "informative", "nst": "2", "beta1": "0.9",
           "beta2": "0.999", "epsilon": "1e-8", "temperature": "0.5"}


def _mlp_runner(method, momentum, fused_steps, device):
    """A width-16 MLP runner of `method` on `device`: 5 steps an epoch, 2
    epochs in the cycle (no cycle end in the first)."""
    cfg = Config(method=method, hparams=dict(ADAM_HP), dataset="synthetic",
                 backbone="mlp_mnist", epochs=2, batch_size=16, lr=1e-3,
                 momentum=momentum, num_cycles=1, seed=0, val_heldout=0.2,
                 device=device, fused_steps=fused_steps)
    cfg.synthetic_n_train = 100
    cfg.synthetic_n_test = 16
    train, _, _, nd = prepare(cfg)
    model, _, _ = create_backbone("mlp_mnist", width=16, depth=2)
    tgt, th, ns = make_flat_target(model, nd_size=nd,
                                   num_classes=cfg.num_classes,
                                   rng=torch.Generator().manual_seed(0),
                                   device=device)
    return get_runner_cls(method)(tgt, th, ns, cfg), train


@pytest.mark.parametrize("momentum", [0.0, 0.5])
@pytest.mark.parametrize("method", ["adam_sghmc", "adam_csghmc"])
def test_fused_steps_equal_per_step_steps(device, method, momentum):
    """Five steps of an epoch fused (on the card a captured graph per
    collect flag, replayed) against the same five per step: the Adam state,
    theta and buf bit for bit, the bias corrections read from the fused
    table's row; on the card the pass launched once a step, and no
    separate draw."""
    out = []
    for fused_steps in (False, True):
        runner, train = _mlp_runner(method, momentum, fused_steps, device)
        assert len(train) == 5
        if method == "adam_csghmc":
            runner._ensure_sched(len(train))
        before = kernels.launch_counts()
        runner.train_one_epoch(0, train)
        after = kernels.launch_counts()
        st = runner.state
        out.append(({k: getattr(st, k).clone() for k in
                     ("theta", "buf", "v_mom", "m", "v2")},
                    (st.t, st.step),
                    {k: after[k] - before[k] for k in after}))
    assert out[0][1] == out[1][1] == (5, 5)
    for k in out[0][0]:
        assert torch.equal(out[0][0][k], out[1][0][k]), k
    want = dict.fromkeys(kernels.launch_counts(), 0)
    if device == "cuda":
        want["adam_sghmc_update"] = 5
    assert out[0][2] == out[1][2] == want
