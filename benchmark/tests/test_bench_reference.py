"""The plain reference held against the program at tiny widths on the CPU:
its reading of the flat vector, its forward passes, the sampler's noise,
update and moments, and the mixture predictive."""

from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import build
from benchmark.reference import layout, models, precision, predictive, sampler

from conftest import DATA, ROOT

CONFIGS = {n: json.loads((DATA / "configs" / f"{n}.json").read_text())
           for n in ("tiny_vit", "tiny_resnet")}
SAMPLE = json.loads((DATA / "traffic" / "sample.json").read_text())


def program(name, dtype="float32"):
    c = dict(CONFIGS[name], compute_dtype=dtype)
    cfg = build.port_config(c, SAMPLE, 3, "cpu")
    tgt, ns, lay = build.target(cfg, c, 32, 3, "cpu")
    return c, tgt, ns, lay


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmark.reference.models, "
            "benchmark.reference.sampler, benchmark.reference.predictive, "
            "benchmark.reference.precision, benchmark.reference.layout, "
            "benchmark.reference.arch.vit, benchmark.reference.arch.resnet; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    mods = set(eval(out))
    assert not mods & {"bayesdll_tpu_torch", "bayesdll_tpu", "jax", "flax"}


@pytest.mark.parametrize("name", ["tiny_vit", "tiny_resnet"])
def test_layout_is_the_programs(name):
    from bayesdll_tpu_torch.core import flat
    c, tgt, _, lay = program(name)
    th = torch.arange(lay.dim, dtype=torch.float32)
    ours = {"/".join(k): v for k, v in lay.unravel(th).items()}
    theirs = {k.replace(".", "/"): v
              for k, v in flat.dotted(tgt.unravel(th)).items()}
    assert ours.keys() == theirs.keys()
    assert all(torch.equal(ours[k], theirs[k]) for k in ours)
    assert torch.equal(lay.is_head("cpu"), tgt.is_head)


@pytest.mark.parametrize("name,train", [("tiny_vit", True),
                                        ("tiny_resnet", True),
                                        ("tiny_resnet", False)])
def test_forward_is_the_programs_in_fp32(name, train):
    c, tgt, ns, lay = program(name)
    th = build.theta(lay, 5, "cpu")
    x = torch.randn(6, c["image_size"], c["image_size"], 3)
    stats = None
    if "batch_stats" in ns:
        stats = models.batch_stats(lay.unravel(th), x, c)
        ns = {"batch_stats": build.nested_stats(stats)}
    want, _ = tgt.forward(th, ns, x, train=train)
    got = models.forward(lay.unravel(th), x, c, precision.Products("fp32"),
                         stats, train)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_philox_noise_is_the_kernels_counter_layout():
    """Stream 0 (csghmc_update) of the card's noise, worked out by the
    reference, against the program's plain version of the same draw."""
    from bayesdll_tpu_torch.ops import fused
    for seed, step, n in ((3, 0, 4099), (2 ** 31 + 11, 7, 1027),
                          (2 ** 40 + 5, 2 ** 33 + 1, 64)):
        ours = sampler.philox_normals(n, seed=seed, step=step, device="cpu",
                                      block=256)
        theirs = fused.philox_draw_plain(n, kind="normal", stream=0,
                                         seed=seed, step=step)
        assert torch.allclose(ours, theirs, rtol=0, atol=1e-6)


def test_cpu_noise_and_step_are_the_programs():
    from bayesdll_tpu_torch.ops import fused
    n = 4096
    g, th, v = torch.randn(n) * 1e-3, torch.randn(n) * 0.05, torch.randn(n) * 1e-5
    lr = torch.full((n,), 1e-3)
    kw = dict(prior_sig=1.0, n_eff=3312.0, nd=1.0, alpha=0.05)
    th_p, v_p = th.clone(), v.clone()
    fused.csghmc_update_(g, th_p, v_p, lr=lr, should_sample=True, seed=9,
                         step=4, **kw)
    th_r, v_r = th.clone(), v.clone()
    z = sampler.normals(n, seed=9, step=4, device="cpu")
    sampler.csghmc_step(th_r, v_r, g, lr, prior_sig=1.0, alpha=0.05, nd=1.0,
                        n_eff=3312.0, z=z)
    assert torch.allclose(v_r, v_p, rtol=1e-5, atol=1e-12)
    assert torch.allclose(th_r, th_p, rtol=1e-6, atol=1e-12)


def test_welford_and_schedule_are_the_programs():
    from bayesdll_tpu_torch.core.moments import WelfordMoments
    from bayesdll_tpu_torch.core.schedule import CyclicalSchedule
    xs = [torch.randn(64) for _ in range(4)]
    ours, theirs = sampler.Welford(xs[0]), WelfordMoments.zeros(64, "cpu")
    for x in xs:
        ours.update(x)
        theirs.update(x)
    assert torch.allclose(ours.var(), theirs.mean_var()[1])
    s = CyclicalSchedule(1e-3, 4, 10, 25, 0.5)
    r = sampler.Schedule(1e-3, 4, 10, 25, 0.5, 2)
    for step in range(250):
        assert r.lr(step) == s.lr_py(step)
        assert r.gate(step) == (s.should_sample_py(step)
                                and (step % 25) % 2 == 0)
    assert sampler.splitmix_seed(7, 1, 2, 3) == __import__(
        "bayesdll_tpu_torch.core.rng", fromlist=["mix"]).mix(7, 1, 2, 3)


def test_mixture_is_the_programs():
    """The reference's GMM predictive against the runner's
    mixture_evaluate (fp32, CPU) on two components."""
    from bayesdll_tpu_torch.data import ArrayLoader
    c, tgt, ns, lay = program("tiny_vit")
    cfg = build.port_config(c, dict(SAMPLE, nst=3), 4, "cpu")
    base = build.theta(lay, 4, "cpu")
    traffic = {"components": 2, "nst": 3, "component_scale": 0.1,
               "likelihood_nll": [2.0, 2.4]}
    comps = build.components(lay, base, traffic, 4, "cpu")
    runner = build.runner(cfg, tgt, base, ns)
    runner.cycle_stats = {k: dict(v, n=0, theta=None)
                          for k, v in comps.items()}
    x = np.random.default_rng(0).standard_normal((10, 32, 32, 3)).astype(
        np.float32)
    y = np.zeros(10, np.int32)
    out = runner.evaluate(ArrayLoader(x, y, 8))
    w = predictive.gmm_weights({k: v["likelihoods"] for k, v in comps.items()})
    dev_comps = [(w[k], torch.as_tensor(v["mean"]), torch.as_tensor(v["var"]),
                  k) for k, v in sorted(comps.items())]
    for i, rows in ((0, slice(0, 8)), (1, slice(8, 10))):
        ref = predictive.mixture_logp(
            lambda th, xb: models.forward(lay.unravel(th), xb, c,
                                          precision.Products("fp32")),
            dev_comps, torch.as_tensor(x[rows]), seed=4, batch_index=i, nst=3,
            device="cpu")
        mix = torch.as_tensor(out[3][rows], dtype=torch.float64)
        prog = mix - torch.logsumexp(mix, -1, keepdim=True)
        assert torch.allclose(prog, ref, atol=1e-4)
    assert math.isclose(sum(w.values()), 1.0)


def test_fp8_products_round_inputs_and_output_gradients():
    from benchmark.reference import precision
    x = torch.linspace(-3.0, 3.0, 1001)
    r = precision._Fp8Input.apply(x)
    rel = ((r - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert 0.01 < float(rel.max()) <= 2 ** -4 + 1e-6   # e4m3: 3 bits
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 4)
    precision.Products("fp8").mm(a, b).backward(torch.linspace(0.1, 1, 32)
                                                .reshape(8, 4))
    exact = torch.linspace(0.1, 1, 32).reshape(8, 4) @ \
        precision._Fp8Input.apply(b).T
    gap = float((a.grad - exact).abs().max() / exact.abs().max())
    assert 1e-3 < gap < 0.2                             # e5m2 gradients
    fp32 = precision.Products("fp32")
    assert torch.equal(fp32.mm(a, b), a @ b)
