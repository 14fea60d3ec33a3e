#!/usr/bin/env python3
"""Smoke test of the PyTorch port (bayesdll_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases, one line each:
  1. the card (nvidia-smi name and power limit), the kernel build from
     bayesdll_tpu_torch/csrc (one nvcc per source, all started together),
     fp32 matmuls pinned (TF32 off);
  2. every kernel (csghmc_update, sgld_update, sghmc_update) against its
     plain PyTorch version at the main path's shapes (full-width
     mlp_mnist: D = 2,797,568), with its noise checked against the closed
     form;
  3. the paths: cSGHMC, SGLD, SGHMC and cSGLD training of the full-width
     MNIST MLP (784 -> 3x1000 -> 10) on synthetic data, batch 128, 2
     epochs, through the entry points a user calls, every kernel's launches
     counted from 0 just before each run and read just after; then small
     runs on the card held against the same runs on the CPU;
  4. times with CUDA events: each kernel, its plain version, its bound,
     and the cSGHMC and SGHMC training steps;
  5. those training steps' device time by kernel (torch.profiler).
The line before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.  Any failure raises, and the script exits
non-zero with no result line; with no CUDA card it stops at once.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "1.0", "thin": "2",
      "bias": "informative", "nst": "2", "momentum_decay": "0.05"}
SG_HP = dict(HP, burnin="1")  # SGLD and SGHMC: moments from epoch 1 on
LR_SG = 1e-2  # SGLD, SGHMC and cSGLD (see PATHS)
TOL = dict(rtol=1e-6, atol=1e-6)  # as tests/test_pallas_kernels.py
STEPS_TIMED = 50
PROFILED_STEPS = 10


def check(cond: bool, what: str):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def peak_bytes_per_s(name: str) -> float:
    """Device memory rate of the part (NVIDIA data sheets)."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12
    if "H100" in n and "PCIE" in n:
        return 2.0e12
    if "H100" in n and "NVL" in n:
        return 3.9e12
    return 3.35e12  # H100 SXM


FP32_PEAK = 67e12  # H100 SXM, fp32 outside the tensor cores


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cold(fn, iters: int, flush: torch.Tensor, warmup: int = 3) -> float:
    """Mean ms of fn with the L2 cache emptied of its operands before each
    call, as the training step leaves it after the forward and backward
    passes.  The flush reads a buffer larger than L2, so it leaves no dirty
    lines for fn to write back."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    from bayesdll_tpu_torch.ops import kernels
    secs = kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 1: built {list(kernels.KERNELS)} in {secs:.1f} s "
          f"(sm_90a); matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    return smi


def full_width_target(nd_size: int):
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.models import create_backbone
    model, _, _ = create_backbone("mlp_mnist")
    return make_flat_target(model, nd_size=nd_size, num_classes=10,
                            rng=torch.Generator().manual_seed(0),
                            device="cuda")


def csghmc_inputs(target, lr_body=1e-2, lr_head=2e-2):
    gen = torch.Generator(device="cuda").manual_seed(1)
    d = target.dim
    g = 0.1 * torch.randn(d, generator=gen, device="cuda")
    theta = 0.05 * torch.randn(d, generator=gen, device="cuda")
    v = 0.01 * torch.randn(d, generator=gen, device="cuda")
    lr = target.lr_vec(lr_body, lr_head)  # head-scaled, as the runner's
    return g, theta, v, lr


def phase_kernels():
    """csghmc_update against its plain version at the main path's D."""
    from bayesdll_tpu_torch.ops import fused, kernels
    target, _, _ = full_width_target(nd_size=1000)
    g, theta, v, lr = csghmc_inputs(target)
    kw = dict(prior_sig=1.0, alpha=0.05)
    n_eff = 1000.0

    def kern(nd, gate, seed=7, step=11, a=(g, theta, v, lr)):
        gg, th, vv, ll = (t.clone() for t in a)
        kernels.csghmc_update(
            gg, th, vv, ll, noise_pref=kernels.noise_prefactor(nd, kw["alpha"], n_eff),
            gate=gate, seed=seed, step=step, **kw)
        return th, vv

    th_p, v_p = fused.csghmc_update(g, theta, v, n_eff=n_eff, nd=0.0, lr=lr,
                                    should_sample=True, **kw)
    th_k, v_k = kern(0.0, True)
    torch.cuda.synchronize()
    err = max(float((th_k - th_p).abs().max()), float((v_k - v_p).abs().max()))
    check(torch.allclose(th_k, th_p, **TOL) and torch.allclose(v_k, v_p, **TOL),
          f"kernel vs plain at nd=0: max abs err {err}")

    # scalar tail (n % 4 != 0) on a short vector
    n = 1027
    small = [t[:n].clone() for t in (g, theta, v, lr)]
    th_ps, v_ps = fused.csghmc_update(*small[:3], n_eff=n_eff, nd=0.0,
                                      lr=small[3], should_sample=True, **kw)
    th_ks, v_ks = kern(0.0, True, a=small)
    check(torch.allclose(th_ks, th_ps, **TOL) and torch.allclose(v_ks, v_ps, **TOL),
          "kernel vs plain with a scalar tail")

    th_g, v_g = kern(1.0, False)
    check(torch.equal(th_g, th_k) and torch.equal(v_g, v_k),
          "gate=0 with nd>0 equals the nd=0 result")

    th_n, v_n = kern(1.0, True)
    injected = (v_n - v_k).double()
    stats = []
    for mask, lr_value in ((~target.is_head, 1e-2), (target.is_head, 2e-2)):
        x = injected[mask]
        want = math.sqrt(2.0 * kw["alpha"] * lr_value) / n_eff
        mean, std = float(x.mean()), float(x.std())
        check(abs(mean) < 4 * want / math.sqrt(x.numel()),
              f"noise mean {mean} at lr {lr_value}")
        check(abs(std - want) / want < 0.02,
              f"noise std {std} vs {want} at lr {lr_value}")
        stats.append(f"lr={lr_value}: n={x.numel()} std/closed-form="
                     f"{std / want:.5f} mean/(sigma/sqrt n)="
                     f"{mean / (want / math.sqrt(x.numel())):+.3f}")

    again = kern(1.0, True)
    check(torch.equal(again[0], th_n) and torch.equal(again[1], v_n),
          "same (seed, step) is bitwise repeatable")
    check(not torch.equal(kern(1.0, True, step=12)[1], v_n),
          "another step draws other noise")
    check(not torch.equal(kern(1.0, True, seed=8)[1], v_n),
          "another seed draws other noise")
    try:  # the wrapper refuses before it launches, so nothing is written
        kernels.csghmc_update(*(t[1:] for t in (g, theta, v, lr)),
                              noise_pref=0.0, gate=False, seed=7, step=11,
                              **kw)
    except ValueError:
        pass
    else:
        raise RuntimeError("check failed: a misaligned pointer must raise")

    print(f"phase 2: csghmc_update vs plain at D={target.dim}: max abs err "
          f"{err:.3g} (rtol=atol=1e-6); tail n={n} ok; gate=0 injects "
          f"nothing; noise {'; '.join(stats)}; repeatable per (seed, step)",
          flush=True)
    return err


SG_ALPHA = {"sgld_update": {}, "sghmc_update": {"alpha": 0.05}}


def sg_inputs(target, lr_body=1e-2, lr_head=2e-2):
    """(g, theta, theta0, v, mask, lr) at D, the mask dropping the bias
    elements as bias=uninformative does, lr head-scaled as the runner's."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    d = target.dim
    g = 0.1 * torch.randn(d, generator=gen, device="cuda")
    theta = 0.05 * torch.randn(d, generator=gen, device="cuda")
    theta0 = 0.05 * torch.randn(d, generator=gen, device="cuda")
    v = 0.01 * torch.randn(d, generator=gen, device="cuda")
    return (g, theta, theta0, v, target.prior_mask("uninformative"),
            target.lr_vec(lr_body, lr_head))


def sg_operands(name, g, theta, theta0, v, mask, lr):
    """The operands of `name` in its argument order (sgld has no v)."""
    if name == "sgld_update":
        return (g, theta, theta0, mask, lr)
    return (g, theta, theta0, v, mask, lr)


def sg_kernel(name, args, *, nd, n_eff, seed=7, step=11):
    """The kernel on copies of `args`; returns what it wrote, with the
    output that carries the noise (g' for sgld, v' for sghmc) last."""
    from bayesdll_tpu_torch.ops import kernels
    out = getattr(kernels, name)(*(t.clone() for t in args), prior_sig=1.0,
                                 n_eff=n_eff, nd=nd, seed=seed, step=step,
                                 **SG_ALPHA[name])
    return out if isinstance(out, tuple) else (out,)


def sg_plain(name, args, *, nd, n_eff, generator=None):
    from bayesdll_tpu_torch.ops import fused
    out = getattr(fused, name)(*args, prior_sig=1.0, n_eff=n_eff, nd=nd,
                               generator=generator, **SG_ALPHA[name])
    return out if isinstance(out, tuple) else (out,)


def sg_noise_std(name, nd, n_eff, lr):
    """Closed-form std of the injected term: nd sqrt(2/(N lr)) for sgld,
    nd sqrt(2 alpha/(N lr)) for sghmc."""
    return nd * math.sqrt(2.0 * SG_ALPHA[name].get("alpha", 1.0) / (n_eff * lr))


def phase_sg_kernels():
    """sgld_update and sghmc_update against their plain versions at the main
    path's D; their noise against the closed form.  Returns the max abs
    error of each at nd = 0."""
    from bayesdll_tpu_torch.ops import kernels
    n_eff = 1000.0
    target, _, _ = full_width_target(nd_size=1000)
    vecs = sg_inputs(target)
    is_head = target.is_head
    errs, z = {}, {}
    for name in SG_ALPHA:
        args = sg_operands(name, *vecs)
        want = sg_plain(name, args, nd=0.0, n_eff=n_eff)
        got = sg_kernel(name, args, nd=0.0, n_eff=n_eff)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(got, want))
        check(all(torch.allclose(a, b, **TOL) for a, b in zip(got, want)),
              f"{name} vs plain at nd=0: max abs err {err}")
        errs[name] = err

        n = 1027  # scalar tail: n % 4 != 0
        small = [t[:n].clone() for t in args]
        check(all(torch.allclose(a, b, **TOL) for a, b in zip(
            sg_kernel(name, small, nd=0.0, n_eff=n_eff),
            sg_plain(name, small, nd=0.0, n_eff=n_eff))),
            f"{name} vs plain with a scalar tail")

        # lr = 0 on a few elements (a run with lr_head 0): finite, as the
        # TPU kernel's clamp at 1e-30 keeps it
        zero_lr = [t.clone() for t in args]
        zero_lr[-1][[0, 5, target.dim - 1]] = 0.0
        k0 = sg_kernel(name, zero_lr, nd=0.0, n_eff=n_eff)
        check(all(torch.allclose(a, b, **TOL) for a, b in zip(
            k0, sg_plain(name, zero_lr, nd=0.0, n_eff=n_eff))),
            f"{name} vs plain with lr = 0 elements")
        check(all(bool(torch.isfinite(t).all()) for t in
                  sg_kernel(name, zero_lr, nd=1.0, n_eff=n_eff)),
              f"{name} finite with lr = 0 elements and noise")

        noisy = sg_kernel(name, args, nd=1.0, n_eff=n_eff)
        injected = (noisy[-1] - got[-1]).double()
        lr = args[-1].double()
        z[name] = injected * math.sqrt(n_eff) / torch.sqrt(
            2.0 * SG_ALPHA[name].get("alpha", 1.0) / lr)
        stats = []
        for mask, lr_value in ((~is_head, 1e-2), (is_head, 2e-2)):
            x = injected[mask]
            want_std = sg_noise_std(name, 1.0, n_eff, lr_value)
            mean, std = float(x.mean()), float(x.std())
            check(abs(mean) < 4 * want_std / math.sqrt(x.numel()),
                  f"{name} noise mean {mean} at lr {lr_value}")
            check(abs(std - want_std) / want_std < 0.02,
                  f"{name} noise std {std} vs {want_std} at lr {lr_value}")
            stats.append(f"lr={lr_value}: n={x.numel()} std/closed-form="
                         f"{std / want_std:.5f} mean/(sigma/sqrt n)="
                         f"{mean / (want_std / math.sqrt(x.numel())):+.3f}")

        again = sg_kernel(name, args, nd=1.0, n_eff=n_eff)
        check(all(torch.equal(a, b) for a, b in zip(again, noisy)),
              f"{name}: same (seed, step) is bitwise repeatable")
        check(not torch.equal(sg_kernel(name, args, nd=1.0, n_eff=n_eff,
                                        step=12)[-1], noisy[-1]),
              f"{name}: another step draws other noise")
        check(not torch.equal(sg_kernel(name, args, nd=1.0, n_eff=n_eff,
                                        seed=8)[-1], noisy[-1]),
              f"{name}: another seed draws other noise")
        try:  # the wrapper refuses before it launches, so nothing is written
            getattr(kernels, name)(*(t[1:] for t in args), prior_sig=1.0,
                                   n_eff=n_eff, nd=0.0, seed=7, step=11,
                                   **SG_ALPHA[name])
        except ValueError:
            pass
        else:
            raise RuntimeError(f"check failed: {name}: a misaligned pointer "
                               "must raise")
        print(f"phase 2: {name} vs plain at D={target.dim}: max abs err "
              f"{err:.3g} (rtol=atol=1e-6); tail n={n} ok; lr=0 elements "
              f"finite and equal to plain; noise {'; '.join(stats)}; "
              "repeatable per (seed, step)", flush=True)
    corr = float(torch.corrcoef(torch.stack(
        [z["sgld_update"], z["sghmc_update"]]))[0, 1])
    check(abs(corr) < 5 / math.sqrt(target.dim),
          f"sgld and sghmc draw other normals at one (seed, step): corr {corr}")
    print(f"phase 2: sgld vs sghmc normals at one (seed, step): correlation "
          f"{corr:+.2e} (bound {5 / math.sqrt(target.dim):.1e})", flush=True)
    return errs


def make_runner(cfg, width=None, depth=None, theta_init=None):
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.data import prepare
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models import create_backbone
    loaders = prepare(cfg)
    *loaders, nd = loaders
    kw = {} if width is None else dict(width=width, depth=depth)
    model, _, _ = create_backbone(cfg.backbone, num_classes=cfg.num_classes, **kw)
    target, theta, ns = make_flat_target(
        model, nd_size=nd, num_classes=cfg.num_classes,
        rng=torch.Generator().manual_seed(cfg.seed), device=cfg.device)
    if theta_init is not None:
        theta = theta_init.to(cfg.device)
    return get_runner_cls(cfg.method)(target, theta, ns, cfg), loaders


def reset_launches():
    from bayesdll_tpu_torch.ops import kernels
    for name in kernels.KERNELS:
        getattr(kernels, name).launches = 0


def read_launches() -> dict:
    from bayesdll_tpu_torch.ops import kernels
    return {name: getattr(kernels, name).launches for name in kernels.KERNELS}


# method, hparams, lr, the kernel its step launches.  lr 1e-3 for cSGHMC:
# at the bench's 1e-2 the full-width MLP diverges on this synthetic task
# within two epochs (the JAX package does the same), and a collapsed model
# would hide a wrong step.  SGLD, SGHMC and cSGLD draw noise at every step
# and still learn the task at 1e-2 in two epochs; at 1e-3 they learn it too
# slowly for the error check (PERF.md gives both).
PATHS = (
    ("csghmc", HP, 1e-3, "csghmc_update"),
    ("sgld", SG_HP, LR_SG, "sgld_update"),
    ("sghmc", SG_HP, LR_SG, "sghmc_update"),
    ("csgld", HP, LR_SG, "sgld_update"),
)


def phase_path(method, hp, lr, kernel):
    """One path through the entry points a user calls, every kernel's count
    set to 0 just before it and read just after."""
    from bayesdll_tpu_torch.config import Config

    cfg = Config(method=method, hparams=dict(hp), dataset="synthetic",
                 backbone="mlp_mnist", epochs=2, batch_size=128, lr=lr,
                 num_cycles=2, seed=0, device="cuda")
    runner, loaders = make_runner(cfg)
    check(runner.target.n_params == 2_797_010, "full-width mlp_mnist")
    reset_launches()
    tic = time.perf_counter()
    res = runner.train(*loaders)
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    counts = read_launches()
    steps = cfg.epochs * len(loaders[0])
    check(counts[kernel] == steps,
          f"{method}: {kernel} launches {counts[kernel]} == steps {steps}")
    check(all(n == 0 for k, n in counts.items() if k != kernel),
          f"{method}: no other kernel launched: {counts}")
    check(all(math.isfinite(x) for x in res["train_losses"]),
          f"{method}: finite losses")
    for key in ("nll", "ece", "mce"):
        check(key in res and math.isfinite(res[key]), f"{method}: result {key}")
    check(bool(torch.isfinite(runner.state.theta).all()), f"{method}: finite theta")
    if hasattr(runner, "cycle_stats"):
        done = sorted(c for c, s in runner.cycle_stats.items()
                      if "likelihoods" in s)
        check(done == [1, 2], f"{method}: two completed cycles, got {done}")
        collected = [runner.cycle_stats[c]["n"] for c in done]
    else:
        collected = [runner.state.moments.cnt]
    check(min(collected) > 1, f"{method}: collected {collected} samples")
    check(res["test_err"] < 0.5, f"{method}: test error {res['test_err']} "
          "well below chance (0.9)")
    print(f"phase 3: {method} mlp_mnist D={runner.target.dim} "
          f"({runner.target.n_params} params) lr={lr}, {steps} steps in "
          f"{secs:.2f} s incl. eval; launches {counts}; losses="
          f"{[round(x, 4) for x in res['train_losses']]}; nll={res['nll']:.4f} "
          f"ece={res['ece']:.4f} mce={res['mce']:.4f} "
          f"test_err={res['test_err']:.4f}; collected={collected}", flush=True)
    return runner, loaders, counts[kernel]


def phase_reference(method, hp, momentum=0.0):
    """A small run on the card against the same run on the CPU (nd = 0: no
    noise, so the two agree up to fp32 rounding)."""
    from bayesdll_tpu_torch.config import Config

    out = {}
    for device in ("cpu", "cuda"):
        cfg = Config(method=method, hparams=dict(hp, nd="0.0", nst="0"),
                     dataset="synthetic", backbone="mlp_mnist", epochs=2,
                     batch_size=64, lr=2e-2, momentum=momentum, num_cycles=2,
                     seed=0, val_heldout=0.15, device=device)
        cfg.synthetic_n_train = 512
        cfg.synthetic_n_test = 256
        runner, loaders = make_runner(cfg, width=32, depth=2)
        res = runner.train(*loaders)
        out[device] = (res, runner.state.theta.cpu())
    (rc, tc), (rg, tg) = out["cpu"], out["cuda"]
    err = float((tg - tc).abs().max())
    check(torch.allclose(tg, tc, rtol=1e-4, atol=1e-5),
          f"{method}: card vs CPU theta after training: max abs err {err}")
    for key in ("nll", "ece"):
        check(abs(rg[key] - rc[key]) < 1e-3, f"{method}: card vs CPU {key}")
    print(f"phase 3b: {method} width-32 run, momentum {momentum}, card vs CPU: "
          f"theta max abs err {err:.3g} (rtol 1e-4, atol 1e-5); nll "
          f"{rg['nll']:.5f} vs {rc['nll']:.5f}; ece {rg['ece']:.5f} vs "
          f"{rc['ece']:.5f}", flush=True)


def bound(nbytes: float, nops: float, name: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the fp32 rate."""
    bytes_ms = nbytes / peak_bytes_per_s(name) * 1e3
    ops_ms = nops / FP32_PEAK * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def kernel_times(smi, name, kern, plain, nbytes, nops, flush, on_off):
    """plain, kernel, kernel, plain with L2 flushed before each launch
    (compared within one call, in turns), then the kernel back to back.
    `kern(flag)` launches with noise on or off."""
    dev = torch.cuda.get_device_name(0)
    p1 = cuda_ms_cold(plain, 50, flush)
    k_on = cuda_ms_cold(lambda: kern(True), 200, flush)
    k_off = cuda_ms_cold(lambda: kern(False), 200, flush)
    p2 = cuda_ms_cold(plain, 50, flush)
    k_warm = cuda_ms(lambda: kern(True), 200)  # back to back: L2 holds part
    plain_ms = (p1 + p2) / 2
    bound_ms, bound_by = bound(nbytes, nops, dev)
    print(f"phase 4: [{smi}] {name} D={nbytes // BYTES_PER_ELEM[name]}, L2 "
          f"flushed before each launch: kernel {k_on * 1e3:.2f} us (noise on), "
          f"{k_off * 1e3:.2f} us ({on_off}); {k_warm * 1e3:.2f} us back to "
          f"back; bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} MB at "
          f"{peak_bytes_per_s(dev) / 1e12:.2f} TB/s, {bound_by}) = "
          f"{bound_ms / k_on:.1%} of roofline; plain PyTorch "
          f"{plain_ms * 1e3:.2f} us ({p1 * 1e3:.2f}/{p2 * 1e3:.2f}); "
          f"{nbytes / (k_on * 1e-3) / 1e12:.2f} TB/s achieved", flush=True)
    return dict(ms=k_on, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# bytes each launch must move per element: every operand read once, every
# output written once (fp32)
BYTES_PER_ELEM = {"csghmc_update": 24,  # read g, theta, v, lr; write theta, v
                  "sgld_update": 24,    # read g, theta, theta0, mask, lr; write g
                  "sghmc_update": 32}   # read g, theta, theta0, v, mask, lr; write g, v
# operations per element, all counted at the fp32 rate (a generous bound:
# integer ops run slower): the update's arithmetic plus ~35 for a quarter of
# a Philox call and half a Box-Muller pair
OPS_PER_ELEM = {"csghmc_update": 45, "sgld_update": 45, "sghmc_update": 50}


def phase_kernel_times(smi, target):
    from bayesdll_tpu_torch.ops import fused, kernels
    d = target.dim
    n_eff = float(target.nd_size)
    flush = torch.zeros(64 * 2**20, device="cuda")  # 256 MB, 5x the L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = [0]
    out = {}

    g, theta, v, lr = csghmc_inputs(target, lr_body=1e-4, lr_head=2e-4)
    kw = dict(prior_sig=1.0, alpha=0.05)
    pref = kernels.noise_prefactor(1.0, kw["alpha"], n_eff)

    def csghmc(gate):
        step[0] += 1
        kernels.csghmc_update(g, theta, v, lr, noise_pref=pref, gate=gate,
                              seed=0, step=step[0], **kw)

    out["csghmc_update"] = kernel_times(
        smi, "csghmc_update", csghmc,
        lambda: fused.csghmc_update(g, theta, v, n_eff=n_eff, nd=1.0, lr=lr,
                                    should_sample=True, generator=gen, **kw),
        BYTES_PER_ELEM["csghmc_update"] * d, OPS_PER_ELEM["csghmc_update"] * d,
        flush, "noise gate off")

    vecs = sg_inputs(target, lr_body=1e-4, lr_head=2e-4)
    for name in SG_ALPHA:
        args = sg_operands(name, *vecs)

        def sg(noise, name=name, args=args):
            step[0] += 1
            getattr(kernels, name)(*args, prior_sig=1.0, n_eff=n_eff,
                                   nd=1.0 if noise else 0.0, seed=0,
                                   step=step[0], **SG_ALPHA[name])

        out[name] = kernel_times(
            smi, name, sg,
            lambda name=name, args=args: sg_plain(name, args, nd=1.0,
                                                  n_eff=n_eff, generator=gen),
            BYTES_PER_ELEM[name] * d, OPS_PER_ELEM[name] * d, flush,
            "nd = 0, no draw")
    return out


def phase_step_time(smi, method, runner, loaders):
    """The training step at batch 128 through run_steps, on batches already
    on the card; then its profile."""
    train = loaders[0]
    xs, ys = [], []
    for x, y, _ in train:
        xs.append(x)
        ys.append(y)
        if len(xs) == STEPS_TIMED:
            break
    while len(xs) < STEPS_TIMED:
        xs, ys = xs + xs, ys + ys
    xs = torch.from_numpy(np.stack(xs[:STEPS_TIMED])).cuda()
    ys = torch.from_numpy(np.stack(ys[:STEPS_TIMED])).cuda()
    ep = runner.cfg.epochs - 1
    runner.run_steps(ep, xs[:5], ys[:5], runner.bi)  # warm-up
    torch.cuda.synchronize()
    tic = time.perf_counter()
    loss_k, _ = runner.run_steps(ep, xs, ys, runner.bi)
    torch.cuda.synchronize()
    dt = time.perf_counter() - tic
    check(bool(torch.isfinite(loss_k).all()),
          f"{method}: finite losses in the timed steps")
    ms_step = dt / STEPS_TIMED * 1e3
    gevals = STEPS_TIMED * xs.shape[1] / dt
    print(f"phase 4: [{smi}] {method} training step mlp_mnist batch "
          f"{xs.shape[1]}: {ms_step:.3f} ms/step over {STEPS_TIMED} run_steps "
          f"steps = {gevals:.0f} gradient-evals/s", flush=True)
    phase_profile(smi, method, runner, xs[:PROFILED_STEPS],
                  ys[:PROFILED_STEPS], ms_step)


def phase_profile(smi, method, runner, xs, ys, ms_step):
    """Where a training step's device time goes: torch.profiler over a few
    run_steps steps, device time summed by kernel name.  The busy share
    divides the device time per step by the unprofiled ms/step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.run_steps(runner.cfg.epochs - 1, xs, ys, runner.bi)
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / len(xs)
    total = sum(per_kernel.values())
    if total <= 0:
        print(f"phase 5: {method}: profiler recorded no device time: "
              "breakdown not measured", flush=True)
        return
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    shares = "; ".join(f"{name[:60]} {us:.1f} us ({us / total:.1%})"
                       for name, us in top)
    print(f"phase 5: [{smi}] {method} profile over {len(xs)} steps: device time "
          f"{total:.1f} us/step = {total / (ms_step * 1e3):.1%} busy of "
          f"{ms_step:.3f} ms/step; by kernel: {shares}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    smi = phase_device()
    errs = {"csghmc_update": phase_kernels(), **phase_sg_kernels()}
    runners, launches = {}, {}
    for method, hp, lr, kernel in PATHS:
        runner, loaders, n = phase_path(method, hp, lr, kernel)
        runners[method] = (runner, loaders)
        launches.setdefault(kernel, n)  # sgld_update: the SGLD path's count
    phase_reference("csghmc", HP)
    phase_reference("sgld", SG_HP, momentum=0.5)
    phase_reference("sghmc", SG_HP, momentum=0.5)
    times = phase_kernel_times(smi, runners["csghmc"][0].target)
    for method in ("csghmc", "sghmc"):
        phase_step_time(smi, method, *runners[method])
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"bayesdll_tpu_torch/csrc/{name}.cu",
        "replaces": f"bayesdll_tpu/ops/pallas_kernels.py:{REPLACES[name]}",
        "launches": launches[name], "max_abs_err": errs[name], **times[name],
        "library_ms": None} for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# the line of each TPU kernel's wrapper in the JAX package
REPLACES = {"csghmc_update": 80, "sgld_update": 122, "sghmc_update": 164}


if __name__ == "__main__":
    sys.exit(main())
