#!/usr/bin/env python3
"""Smoke test of the PyTorch port (bayesdll_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases, one line each:
  1. the card (nvidia-smi name and power limit), the kernel build from
     bayesdll_tpu_torch/csrc (one nvcc per source, all started together),
     fp32 matmuls and convolutions pinned (TF32 off);
  2. every kernel (csghmc_update, sgld_update, sghmc_update) against its
     plain PyTorch version at the main paths' shapes (full-width
     mlp_mnist: D = 2,797,568; csghmc_update also at ResNet-101's
     D = 42,576,896 and ViT-L/32's D = 305,549,312), with its noise checked
     against the closed form;
  3. the paths: cSGHMC, SGLD, SGHMC and cSGLD training of the full-width
     MNIST MLP (784 -> 3x1000 -> 10) on synthetic data, batch 128, 2
     epochs; cSGHMC training of the full-width ResNet-101 (37 classes,
     bf16 forward, batch 256, 224x224x3 synthetic images); and cSGHMC
     training of the full-width ViT-L/32 (37 classes, bf16 forward through
     the whole-vector cast, batch 128, 224x224x3 synthetic images,
     checkpoints written to a temporary directory), all through the entry
     points a user calls, every kernel's launches counted from 0 just
     before each run and read just after; then small runs on the card held
     against the same runs on the CPU (MLP width 32; a ResNet with one
     bottleneck per stage; vit_tiny, and its remat gradient);
  4. times with CUDA events: each kernel, its plain version, its bound, at
     each main path's D (all three at ViT-L/32's), and the training steps:
     the MLP's cSGHMC (fp32 and bf16) and SGHMC steps, ResNet-101's and
     ViT-L/32's cSGHMC steps (without remat and with remat_policy="names")
     and ViT-B/16's (ms/step, gradient-evals/s, TFLOP/s, the share of the
     bf16 peak, peak device memory);
  5. those training steps' device time by kernel and by family
     (torch.profiler); for ViT-L/32 also the shares of the whole-vector
     cast and its backward, the per-step lr vector and the Welford update.
The MLP and ResNet runners are freed before the ViT-L/32 phases.  The line
before the last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.  Any failure raises, and the script exits
non-zero with no result line; with no CUDA card it stops at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

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
BF16_PEAK = 989e12  # H100 SXM, bf16 dense on the tensor cores
# forward FLOPs of one 224x224 ResNet-101 example (7.85 GMACs, torchvision's
# profile), as bayesdll_tpu/utils/profiling.py counts them; a training step
# is 3 forwards' worth
RESNET101_FWD_FLOPS = 15.7e9

# the JAX bench's ResNet-101 cell (bench.py::resnet101_mfu): cSGHMC, 37
# classes (Pets), batch 256, bf16 forward, synthetic data, 40 epochs of 2
# steps.  The bench's hparams but prior_sig: cSGHMC applies it as a weight
# decay (grad_U = g + prior_sig * theta), and at the bench's 1.0 it pulls
# theta to 0 faster than the data move it, so the model collapses to the
# uniform prediction at every lr tried; 5e-4, a usual ResNet weight decay,
# lets it fit.  With lr 1e-2 the run fits its 513 training images in about
# 30 epochs.  The test error stays at chance whatever the settings: the
# synthetic classes are white-noise images, which a convolutional net with
# global pooling does not tell apart from fresh noise (PERF.md, PR 3), so
# the run is held to the training error and reports the test error.
RESNET = dict(backbone="resnet101", num_classes=37, batch_size=256,
              compute_dtype="bfloat16", epochs=40, num_cycles=2)
RESNET_HP = dict(HP, prior_sig="5e-4")
RESNET_LR = 1e-2
RESNET_TRAIN_ERR = 0.5  # the last epoch's training error, against 0.973
RESNET_PARAMS = 42_575_973
RESNET_STEPS_TIMED = 10
RESNET_PROFILED_STEPS = 3

# the JAX package's ViT bench (tools/big_model_bench.py as tools/hw_sweep.sh
# runs it): cSGHMC on vit_l_32, 37 classes (Pets), batch 128, bf16 forward
# on an fp32 theta, the bench's hparams, 2 cycles; synthetic data, 16 epochs
# of 3 steps, evaluated every 5th epoch (the last included).  lr 1e-3 in
# place of the bench's 1e-2, at which the run does not fit (PERF.md section
# 4 gives the sweep).  Unlike the ResNet, the ViT tells the synthetic
# classes apart (a position-wise linear readout of the patches suffices),
# so the run is held to its test error as well as its training error.
VIT = dict(backbone="vit_l_32", num_classes=37, batch_size=128,
           compute_dtype="bfloat16", epochs=16, num_cycles=2,
           test_eval_freq=5)
VIT_HP = dict(HP)
VIT_LR = 1e-3
VIT_ERR = 0.5  # last epoch's training error and the test error, vs 0.973
VIT_PARAMS = 305_548_325
VIT_DIM = 305_549_312
# forward FLOPs of one 224x224 example (2 x parameters x tokens), as
# bayesdll_tpu/utils/profiling.py counts them
VIT_FWD_FLOPS = {"vit_l_32": 30.5e9, "vit_b_16": 33.8e9}
# timed steps, profiled again from the same step (section 5's busy share
# needs the same collect steps in both)
VIT_STEPS = 6
# checkpoints of the ViT-L/32 run go to a temporary directory here (build/
# is in .gitignore); each holds several 1.22 GB vectors
SCRATCH = Path(__file__).resolve().parent / "build"


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


# the card's name and power limit, as nvidia-smi gives them: every line that
# carries a time or a memory size names it
CARD = ""


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)
    global CARD
    CARD = smi
    from bayesdll_tpu_torch.ops import kernels
    secs = kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # fp32 runs only; bf16 is bf16
    print(f"phase 1: [{smi}] built {list(kernels.KERNELS)} in {secs:.1f} s "
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


def phase_kernels(target, label: str):
    """csghmc_update against its plain version at `target`'s D: bitwise at
    nd = 0, the noise against its closed form."""
    from bayesdll_tpu_torch.ops import fused, kernels
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
    check(torch.equal(th_k, th_p) and torch.equal(v_k, v_p),
          f"kernel vs plain at nd=0, D={target.dim}: max abs err {err}")

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

    print(f"phase 2: csghmc_update vs plain at D={target.dim} ({label}): "
          f"bitwise equal at nd=0 (max abs err {err:.3g}); tail n={n} ok; "
          f"gate=0 injects nothing; noise {'; '.join(stats)}; repeatable per "
          "(seed, step)", flush=True)
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


def make_runner(cfg, width=None, depth=None):
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.data import prepare
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models import create_backbone
    loaders = prepare(cfg)
    *loaders, nd = loaders
    kw = {} if width is None else dict(width=width, depth=depth)
    model, _, meta = create_backbone(cfg.backbone, num_classes=cfg.num_classes,
                                     **cfg.backbone_kw(), **kw)
    target, theta, ns = make_flat_target(
        model, nd_size=nd, num_classes=cfg.num_classes,
        rng=torch.Generator().manual_seed(cfg.seed),
        has_batch_stats=meta["has_batch_stats"], device=cfg.device)
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
    print(f"phase 3: [{CARD}] {method} mlp_mnist D={runner.target.dim} "
          f"({runner.target.n_params} params) lr={lr}, {steps} steps in "
          f"{secs:.2f} s incl. eval; launches {counts}; losses="
          f"{[round(x, 4) for x in res['train_losses']]}; nll={res['nll']:.4f} "
          f"ece={res['ece']:.4f} mce={res['mce']:.4f} "
          f"test_err={res['test_err']:.4f}; collected={collected}", flush=True)
    return runner, loaders, counts[kernel]


# the reference run, then the run on the card
REF_DEVICES = ("cpu", "cuda")


def phase_reference(method, hp, momentum=0.0):
    """A small run on the card against the same run on the CPU (nd = 0: no
    noise, so the two agree up to fp32 rounding)."""
    from bayesdll_tpu_torch.config import Config

    out = {}
    for device in REF_DEVICES:
        cfg = Config(method=method, hparams=dict(hp, nd="0.0", nst="0"),
                     dataset="synthetic", backbone="mlp_mnist", epochs=2,
                     batch_size=64, lr=2e-2, momentum=momentum, num_cycles=2,
                     seed=0, val_heldout=0.15, device=device)
        cfg.synthetic_n_train = 512
        cfg.synthetic_n_test = 256
        runner, loaders = make_runner(cfg, width=32, depth=2)
        res = runner.train(*loaders)
        out[device] = (res, runner.state.theta.cpu())
    (rc, tc), (rg, tg) = (out[d] for d in REF_DEVICES)
    err = float((tg - tc).abs().max())
    check(torch.allclose(tg, tc, rtol=1e-4, atol=1e-5),
          f"{method}: card vs CPU theta after training: max abs err {err}")
    for key in ("nll", "ece"):
        check(abs(rg[key] - rc[key]) < 1e-3, f"{method}: card vs CPU {key}")
    print(f"phase 3b: {method} width-32 run, momentum {momentum}, card vs CPU: "
          f"theta max abs err {err:.3g} (rtol 1e-4, atol 1e-5); nll "
          f"{rg['nll']:.5f} vs {rc['nll']:.5f}; ece {rg['ece']:.5f} vs "
          f"{rc['ece']:.5f}", flush=True)


def tree_clone(tree):
    if isinstance(tree, dict):
        return {k: tree_clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def flat_cpu(tree) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).double().cpu()
                      for t in tree_leaves(tree)])


def resnet_runner():
    """The ResNet-101 cSGHMC runner of the main path and its loaders,
    through prepare, create_backbone, make_flat_target and get_runner_cls.
    No workdir: no GB-sized checkpoint is written."""
    from bayesdll_tpu_torch.config import Config

    cfg = Config(method="csghmc", hparams=dict(RESNET_HP), dataset="synthetic",
                 lr=RESNET_LR, seed=0, device="cuda", **RESNET)
    runner, loaders = make_runner(cfg)
    check(runner.target.n_params == RESNET_PARAMS,
          f"resnet101 at 37 classes: {runner.target.n_params} parameters")
    return runner, loaders


def phase_resnet_path(runner, loaders) -> int:
    """ResNet-101 cSGHMC through `train`, the counts set to 0 just before
    and read just after."""
    cfg = runner.cfg
    stats0 = tree_clone(runner.net_state["batch_stats"])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tic = time.perf_counter()
    res = runner.train(*loaders)
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = cfg.epochs * len(loaders[0])
    moved = float((flat_cpu(runner.net_state["batch_stats"])
                   - flat_cpu(stats0)).abs().max())
    losses, errs = res["train_losses"], res["train_errors"]
    done = sorted(c for c, st in runner.cycle_stats.items() if "likelihoods" in st)
    chance = 1.0 - 1.0 / cfg.num_classes
    print(f"phase 3: [{CARD}] csghmc resnet101 bf16 D={runner.target.dim} "
          f"({runner.target.n_params} params) batch {cfg.batch_size} "
          f"lr={cfg.lr} prior_sig={runner.prior_sig}, {steps} steps in "
          f"{secs:.2f} s incl. eval; launches {counts}; batch_stats moved by "
          f"up to {moved:.4g}; every 4th epoch's train loss "
          f"{[round(x, 4) for x in losses[::4]]} and error "
          f"{[round(x, 4) for x in errs[::4]]}, last epoch {losses[-1]:.4f} "
          f"and {errs[-1]:.4f}; nll={res.get('nll', math.nan):.4f} "
          f"ece={res.get('ece', math.nan):.4f} mce={res.get('mce', math.nan):.4f} "
          f"test_err={res.get('test_err', math.nan):.4f} (chance {chance:.4f}); "
          f"collected={[runner.cycle_stats[c]['n'] for c in done]}; peak device "
          f"memory {peak_gb:.2f} GB (max_memory_allocated)", flush=True)
    check(counts["csghmc_update"] == steps,
          f"resnet101: csghmc_update launches {counts['csghmc_update']} == "
          f"steps {steps}")
    check(all(n == 0 for k, n in counts.items() if k != "csghmc_update"),
          f"resnet101: no other kernel launched: {counts}")
    check(moved > 0, "resnet101: batch_stats changed through training")
    check(all(math.isfinite(x) for x in losses), "resnet101: finite losses")
    check(losses[-1] < losses[0], f"resnet101: train loss falls: {losses}")
    check(errs[-1] < RESNET_TRAIN_ERR,
          f"resnet101: training error {errs[-1]} below {RESNET_TRAIN_ERR}")
    for key in ("nll", "ece", "mce"):
        check(key in res and math.isfinite(res[key]), f"resnet101: result {key}")
    check(bool(torch.isfinite(runner.state.theta).all()), "resnet101: finite theta")
    check(done == [1, 2], f"resnet101: two completed cycles, got {done}")
    check(0.0 <= res["test_err"] <= 1.0, "resnet101: test error measured")
    return counts["csghmc_update"]


# a ResNet with one bottleneck per stage, 32x32 inputs, batch 8: layer4
# normalises over 8 values per channel
MINI = dict(stages=(1, 1, 1, 1), classes=5, hw=32, batch=8, steps=3)


def phase_resnet_reference(method, hp):
    """A few steps of a small ResNet on the card against the same steps on
    the CPU, fp32 with TF32 off, nd = 0.  cuDNN and oneDNN sum in other
    orders; train-mode BatchNorm amplifies the difference to ~1e-5 of the
    activations, which flips the ReLU of the few activations that close to
    0, and each flip moves that element's gradient by its full value.  So
    the runs agree in norm: the gap is within 2% of the distance walked,
    and 99% of elements agree to rtol 1e-4, atol 1e-5 (as
    tests/test_torch_resnet.py holds the port against the JAX package)."""
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models.resnet import ResNet

    m = MINI
    rng = np.random.RandomState(1)
    xs = rng.randn(m["steps"], m["batch"], m["hw"], m["hw"], 3).astype(np.float32)
    ys = rng.randint(0, m["classes"], (m["steps"], m["batch"])).astype(np.int32)
    x_eval = torch.from_numpy(rng.randn(m["batch"], m["hw"], m["hw"], 3)
                              .astype(np.float32))
    out = {}
    for device in REF_DEVICES:
        cfg = Config(method=method, hparams=dict(hp, nd="0.0", nst="0"),
                     dataset="synthetic", backbone="resnet_mini", epochs=1,
                     batch_size=m["batch"], lr=1e-3, num_cycles=1, seed=0,
                     device=device)
        target, theta, ns = make_flat_target(
            ResNet(m["stages"], m["classes"]), nd_size=64,
            num_classes=m["classes"], rng=torch.Generator().manual_seed(0),
            has_batch_stats=True, device=device)
        runner = get_runner_cls(method)(target, theta, ns, cfg)
        if hasattr(runner, "_ensure_sched"):
            runner._ensure_sched(m["steps"])
        start = {"theta": theta.clone(), "v": torch.zeros_like(theta),
                 "batch_stats": tree_clone(ns["batch_stats"])}
        runner.run_steps(0, xs, ys, 0)
        logits, _ = target.forward(runner.state.theta, runner.net_state,
                                   x_eval.to(device), train=False)
        out[device] = {"theta": runner.state.theta,
                       "v": getattr(runner.state, "v", None),
                       "batch_stats": runner.net_state["batch_stats"],
                       "logits": logits}
    shown = []
    ref, card = (out[d] for d in REF_DEVICES)
    for key in ("theta", "v", "batch_stats"):
        if card[key] is None:
            continue
        p, r, s0 = (flat_cpu(t) for t in (card[key], ref[key], start[key]))
        walked = float((r - s0).norm())
        gap = float((p - r).norm())
        close = float(((p - r).abs() <= 1e-5 + 1e-4 * r.abs()).double().mean())
        check(walked > 0 and gap <= 2e-2 * walked and close >= 0.99,
              f"{method} mini resnet card vs CPU {key}: gap {gap:.3g}, walked "
              f"{walked:.3g}, {close:.4%} within rtol 1e-4 atol 1e-5")
        shown.append(f"{key} gap/walked {gap / walked:.3g}, {close:.4%} of "
                     "elements within rtol 1e-4 atol 1e-5")
    lg, lc = card["logits"].cpu(), ref["logits"].cpu()
    check(bool(torch.isfinite(lg).all()) and torch.allclose(lg, lc, rtol=1e-3,
                                                            atol=1e-3),
          f"{method} mini resnet: eval logits card vs CPU "
          f"{float((lg - lc).abs().max())}")
    print(f"phase 3b: {method} ResNet stages (1,1,1,1) {m['hw']}x{m['hw']} "
          f"batch {m['batch']} fp32, {m['steps']} steps at nd=0, card vs CPU "
          f"(bound: gap <= 2% of the walk, >= 99% of elements close): "
          f"{'; '.join(shown)}; eval logits max abs err "
          f"{float((lg - lc).abs().max()):.3g} (rtol=atol=1e-3)", flush=True)


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


# the line of each TPU kernel's wrapper in the JAX package
REPLACES = {"csghmc_update": 80, "sgld_update": 122, "sghmc_update": 164}
# bytes each launch must move per element: every operand read once, every
# output written once (fp32)
BYTES_PER_ELEM = {"csghmc_update": 24,  # read g, theta, v, lr; write theta, v
                  "sgld_update": 24,    # read g, theta, theta0, mask, lr; write g
                  "sghmc_update": 32}   # read g, theta, theta0, v, mask, lr; write g, v
# operations per element, all counted at the fp32 rate (a generous bound:
# integer ops run slower): the update's arithmetic plus ~35 for a quarter of
# a Philox call and half a Box-Muller pair
OPS_PER_ELEM = {"csghmc_update": 45, "sgld_update": 45, "sghmc_update": 50}


def kernel_times_at(smi, target, names=tuple(REPLACES)):
    """Each kernel in `names` cold against its bound and its plain version
    at `target`'s D, the operands freed before the next."""
    from bayesdll_tpu_torch.ops import fused, kernels
    flush = torch.zeros(64 * 2**20, device="cuda")  # 256 MB, 5x the L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = [0]
    out = {}
    kw = dict(prior_sig=1.0, alpha=0.05)
    d = target.dim
    n_eff = float(target.nd_size)

    if "csghmc_update" in names:
        g, theta, v, lr = csghmc_inputs(target, lr_body=1e-4, lr_head=2e-4)
        pref = kernels.noise_prefactor(1.0, kw["alpha"], n_eff)

        def csghmc(gate):
            step[0] += 1
            kernels.csghmc_update(g, theta, v, lr, noise_pref=pref, gate=gate,
                                  seed=0, step=step[0], **kw)

        out["csghmc_update"] = kernel_times(
            smi, "csghmc_update", csghmc,
            lambda: fused.csghmc_update(
                g, theta, v, n_eff=n_eff, nd=1.0, lr=lr, should_sample=True,
                generator=gen, **kw),
            BYTES_PER_ELEM["csghmc_update"] * d,
            OPS_PER_ELEM["csghmc_update"] * d, flush, "noise gate off")
        del g, theta, v, lr
        free_device()

    sg_names = [n for n in names if n in SG_ALPHA]
    vecs = sg_inputs(target, lr_body=1e-4, lr_head=2e-4) if sg_names else ()
    for name in sg_names:
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
    for t in out.values():
        t["dim"] = d
    del vecs, flush
    free_device()
    return out


def free_device():
    """Hand the caching allocator's free blocks back, so the next phase's
    peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_step_time(smi, method, runner, loaders, label="mlp_mnist"):
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
          f"{method} {label}: finite losses in the timed steps")
    ms_step = dt / STEPS_TIMED * 1e3
    gevals = STEPS_TIMED * xs.shape[1] / dt
    print(f"phase 4: [{smi}] {method} training step {label} batch "
          f"{xs.shape[1]}: {ms_step:.3f} ms/step over {STEPS_TIMED} run_steps "
          f"steps = {gevals:.0f} gradient-evals/s", flush=True)
    phase_profile(smi, f"{method} {label}", runner, xs[:PROFILED_STEPS],
                  ys[:PROFILED_STEPS], ms_step, f"{method}_update")


def phase_mlp_bf16_step_time(smi):
    """The MLP cSGHMC step with the bf16 forward through the whole-vector
    cast, the JAX bench headline's dtype, beside the fp32 step."""
    from bayesdll_tpu_torch.config import Config
    cfg = Config(method="csghmc", hparams=dict(HP), dataset="synthetic",
                 backbone="mlp_mnist", epochs=2, batch_size=128, lr=1e-3,
                 num_cycles=2, seed=0, device="cuda", compute_dtype="bfloat16")
    runner, loaders = make_runner(cfg)
    check(runner.target.fwd_cast == "bfloat16", "mlp bf16: whole-vector cast")
    runner._ensure_sched(len(loaders[0]))
    phase_step_time(smi, "csghmc", runner, loaders, label="mlp_mnist bf16")


def big_step_time(smi, label, runner, xs, ys, steps, profiled):
    """A big backbone's cSGHMC step through run_steps on batches already on
    the card (the per-batch pinned copy of a host batch stays out of the
    window): ms/step, gradient-evals/s, TFLOP/s, the share of the bf16
    peak, and the peak device memory of the steps; then the profile of the
    first `profiled` steps of the window, run again from the same step (so
    with the same collect steps, which cost a Welford update each)."""
    name = runner.cfg.backbone
    bs = runner.cfg.batch_size
    xs = [xs[i % len(xs)] for i in range(steps)]
    ys = [ys[i % len(ys)] for i in range(steps)]
    torch.cuda.reset_peak_memory_stats()
    sec, bi0 = host_s_per_step(runner, xs, ys, label)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd = RESNET101_FWD_FLOPS if name == "resnet101" else VIT_FWD_FLOPS[name]
    tflops = 3 * fwd * bs / sec / 1e12
    print(f"phase 4: [{smi}] csghmc training step {label} bf16 batch {bs}: "
          f"{sec * 1e3:.2f} ms/step over {steps} run_steps steps on "
          f"{len(set(map(id, xs)))} distinct batches = {bs / sec:.1f} "
          f"gradient-evals/s; {tflops:.1f} TFLOP/s (3 x {fwd / 1e9:.1f} GFLOP "
          f"x {bs} per step); {name}_mfu_bf16={tflops * 1e12 / BF16_PEAK:.2%} "
          f"of the H100 SXM bf16 dense peak (989 TFLOP/s); peak device memory "
          f"{peak_gb:.2f} GB (max_memory_allocated)", flush=True)
    phase_profile(smi, f"csghmc {label}", runner, xs[:profiled],
                  ys[:profiled], sec * 1e3, "csghmc_update",
                  pieces=name.startswith("vit"), bi0=bi0)
    return dict(ms=sec * 1e3, gevals=bs / sec, tflops=tflops, peak_gb=peak_gb)


def host_s_per_step(runner, xs, ys, label, warmup=2):
    """(seconds per run_steps step on the host clock, the window's first
    step), after `warmup` steps, the window closed by a synchronize."""
    ep = runner.cfg.epochs - 1
    runner.run_steps(ep, xs[:warmup], ys[:warmup], runner.bi)
    torch.cuda.synchronize()
    bi0 = runner.bi
    tic = time.perf_counter()
    loss_k, _ = runner.run_steps(ep, xs, ys, bi0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - tic
    check(bool(torch.isfinite(loss_k).all()),
          f"{label}: finite losses in the timed steps")
    return dt / len(xs), bi0


def device_batches(loader):
    """The loader's batches, copied to the card once."""
    return ([torch.from_numpy(x).cuda() for x, _, _ in loader],
            [torch.from_numpy(y).cuda() for _, y, _ in loader])


def phase_resnet_step_time(smi, runner, loaders):
    """The ResNet-101 cSGHMC step on the run's two train batches; then its
    profile."""
    big_step_time(smi, "resnet101", runner, *device_batches(loaders[0]),
                  RESNET_STEPS_TIMED, RESNET_PROFILED_STEPS)


@contextlib.contextmanager
def labelled_pieces(runner):
    """Marks, for the profiler, the pieces of a step that the ViT profile
    reports on their own: the cast of theta at the unravel (its backward is
    autograd's ToCopyBackward0 nodes, the unravel's SplitWithSizesBackward0),
    the per-step lr vector and the Welford update.  The step computes what it
    computes unmarked."""
    from torch.profiler import record_function
    target = runner.target

    def leaves(theta):
        with record_function(PIECE + "fwd_cast"):
            return target.leaves(theta)

    marked = dataclasses.replace(target)
    marked.leaves = leaves
    lr_vec = runner.cyclical_lr_vec

    def cyclical_lr_vec(lr_t):
        with record_function(PIECE + "cyclical_lr_vec"):
            return lr_vec(lr_t)

    moments = runner.state.moments
    update = moments.update

    def welford(theta):
        with record_function(PIECE + "welford_update"):
            return update(theta)

    runner.target, runner.cyclical_lr_vec = marked, cyclical_lr_vec
    moments.update = welford
    try:
        yield
    finally:
        runner.target = target
        del runner.cyclical_lr_vec, moments.update


PIECE = "piece: "
# autograd nodes whose device time the ViT profile reports
PIECE_NODES = ("ToCopyBackward0", "SplitWithSizesBackward0", "UnbindBackward0")


def piece_name(key: str):
    """The piece a profiler event stands for, or None."""
    if key.startswith(PIECE):
        return key[len(PIECE):]
    return next((n for n in PIECE_NODES if key.endswith(n)), None)


def collect_steps(runner, bi0: int, n: int) -> int:
    """How many of the steps bi0 .. bi0 + n - 1 collect a sample."""
    bi = runner.bi
    flags = []
    for k in range(n):
        runner.bi = bi0 + k
        flags.append(runner.step_scalars(0)["collect"])
    runner.bi = bi
    return sum(flags)


def _device_total(e) -> float:
    us = getattr(e, "device_time_total", None)
    return e.cuda_time_total if us is None else us


def phase_profile(smi, what, runner, xs, ys, ms_step, sampler, pieces=False,
                  bi0=None):
    """Where a training step's device time goes: torch.profiler over a few
    run_steps steps, device time summed by kernel name.  The busy share
    divides the device time per step by the unprofiled ms/step; the
    sampler's share is that of the kernels named after `sampler`.  With
    `pieces`, also the device time under each labelled piece
    (`labelled_pieces`) and autograd node of PIECE_NODES.  The steps run
    from step bi0 (default: the runner's next)."""
    from torch.profiler import ProfilerActivity, profile
    bi0 = runner.bi if bi0 is None else bi0
    collects = collect_steps(runner, bi0, len(xs)) if pieces else 0
    with contextlib.ExitStack() as stack:
        if pieces:
            stack.enter_context(labelled_pieces(runner))
        prof = stack.enter_context(profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        runner.run_steps(runner.cfg.epochs - 1, xs, ys, bi0)
        torch.cuda.synchronize()
    per_kernel, piece_us = {}, {}
    for e in prof.key_averages():
        on_card = e.device_type == torch.autograd.DeviceType.CUDA
        name = piece_name(e.key)
        if name and not on_card:
            # a node and its evaluate_function wrapper hold the same
            # kernels: keep the larger, do not add
            piece_us[name] = max(piece_us.get(name, 0.0), _device_total(e))
        if not on_card or e.key.startswith(PIECE):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + us / len(xs)
    total = sum(per_kernel.values())
    if total <= 0:
        print(f"phase 5: {what}: profiler recorded no device time: "
              "breakdown not measured", flush=True)
        return
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    shares = "; ".join(f"{name[:60]} {us:.1f} us ({us / total:.1%})"
                       for name, us in top)
    samp = sum(us for name, us in per_kernel.items() if sampler in name)
    families = {}
    for name, us in per_kernel.items():
        fam = next((f for f, keys in KERNEL_FAMILIES if any(
            k in name.lower() for k in keys)), "other")
        families[fam] = families.get(fam, 0.0) + us
    fam_shares = ", ".join(f"{f} {us / total:.1%}" for f, us in sorted(
        families.items(), key=lambda kv: -kv[1]))
    extra = ""
    if pieces:
        per = {k: v / max(collects, 1) if k == "welford_update" else
               v / len(xs) for k, v in piece_us.items()}
        extra = "; pieces: " + (", ".join(
            f"{k} {us:.1f} us/{'collect ' if k == 'welford_update' else ''}"
            f"step ({us / total:.2%})" for k, us in sorted(per.items()))
            if any(piece_us.values()) else "not measured (no device time "
            "under the labels)") + f"; {collects} collect steps of {len(xs)}"
    print(f"phase 5: [{smi}] {what} profile over {len(xs)} steps: device time "
          f"{total:.1f} us/step = {total / (ms_step * 1e3):.1%} busy of "
          f"{ms_step:.3f} ms/step; {sampler} {samp:.1f} us/step "
          f"({samp / total:.2%} of device time); by family: {fam_shares}; "
          f"by kernel: {shares}{extra}", flush=True)


# kernel families of the profile, by substrings of the kernel's name, the
# first that matches
KERNEL_FAMILIES = (
    ("sampler", ("_update_kernel",)),
    ("attention", ("flash", "fmha", "sdpa", "attention", "attn")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("batch norm", ("batch_norm",)),
    ("conv and gemm", ("conv", "gemm", "xmma", "cutlass", "cudnn", "wgrad",
                       "dgrad", "fprop", "sm90_", "nvjet")),
    ("elementwise", ("elementwise",)),
    ("reduce", ("reduce",)),
    ("pooling", ("pool",)),
    ("copy and cat", ("cat", "copy", "stack")),
)


# ---- ViT-L/32 ---------------------------------------------------------------

def vit_runner():
    """The ViT-L/32 cSGHMC runner of the main path and its loaders, through
    prepare, create_backbone, make_flat_target and get_runner_cls."""
    from bayesdll_tpu_torch.config import Config

    cfg = Config(method="csghmc", hparams=dict(VIT_HP), dataset="synthetic",
                 lr=VIT_LR, seed=0, device="cuda", **VIT)
    tic = time.perf_counter()
    runner, loaders = make_runner(cfg)
    secs = time.perf_counter() - tic
    t = runner.target
    check(t.n_params == VIT_PARAMS and t.dim == VIT_DIM,
          f"vit_l_32 at 37 classes: {t.n_params} parameters, D={t.dim}")
    check(t.fwd_cast == "bfloat16", "vit_l_32: the whole-vector bf16 cast")
    print(f"phase 3: vit_l_32 runner built in {secs:.1f} s (synthetic data, "
          f"{len(loaders[0])} train batches; init of {t.n_params} parameters "
          "on the host; copy to the card)", flush=True)
    return runner, loaders


def phase_vit_path(runner, loaders) -> int:
    """ViT-L/32 cSGHMC through `train`, the counts set to 0 just before and
    read just after; checkpoints in a temporary directory, deleted after."""
    cfg = runner.cfg
    SCRATCH.mkdir(parents=True, exist_ok=True)
    runner.workdir = tempfile.mkdtemp(prefix="vit_l_32_ckpt_", dir=SCRATCH)
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        tic = time.perf_counter()
        res = runner.train(*loaders)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tic
        counts = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ckpts = {p.name: p.stat().st_size / 1e9
                 for p in Path(runner.workdir).glob("*ckpt.pkl")}
    finally:
        shutil.rmtree(runner.workdir, ignore_errors=True)
        runner.workdir = None
    steps = cfg.epochs * len(loaders[0])
    losses, errs = res["train_losses"], res["train_errors"]
    done = sorted(c for c, st in runner.cycle_stats.items() if "likelihoods" in st)
    chance = 1.0 - 1.0 / cfg.num_classes
    every = max(1, cfg.epochs // 8)
    print(f"phase 3: [{CARD}] csghmc vit_l_32 bf16 D={runner.target.dim} "
          f"({runner.target.n_params} params) batch {cfg.batch_size} "
          f"lr={cfg.lr} prior_sig={runner.prior_sig}, {steps} steps "
          f"({len(loaders[0])} per epoch) in {secs:.2f} s incl. eval and "
          f"checkpoints; launches {counts}; train loss of every {every} "
          f"epochs {[round(x, 4) for x in losses[::every]]} and error "
          f"{[round(x, 4) for x in errs[::every]]}, last epoch {losses[-1]:.4f} "
          f"and {errs[-1]:.4f}; nll={res.get('nll', math.nan):.4f} "
          f"ece={res.get('ece', math.nan):.4f} mce={res.get('mce', math.nan):.4f} "
          f"test_err={res.get('test_err', math.nan):.4f} (chance {chance:.4f}) "
          f"at epoch {res.get('best_epoch')}; collected="
          f"{[runner.cycle_stats[c]['n'] for c in done]}; checkpoints (GB) "
          f"{ {k: round(v, 3) for k, v in sorted(ckpts.items())} }, deleted; "
          f"peak device memory {peak_gb:.2f} GB (max_memory_allocated)",
          flush=True)
    check(counts["csghmc_update"] == steps,
          f"vit_l_32: csghmc_update launches {counts['csghmc_update']} == "
          f"steps {steps}")
    check(all(n == 0 for k, n in counts.items() if k != "csghmc_update"),
          f"vit_l_32: no other kernel launched: {counts}")
    check(all(math.isfinite(x) for x in losses), "vit_l_32: finite losses")
    check(losses[-1] < losses[0], f"vit_l_32: train loss falls: {losses}")
    check(errs[-1] < VIT_ERR,
          f"vit_l_32: training error {errs[-1]} below {VIT_ERR}")
    check(res["test_err"] < VIT_ERR,
          f"vit_l_32: test error {res['test_err']} below {VIT_ERR}")
    for key in ("nll", "ece", "mce"):
        check(key in res and math.isfinite(res[key]), f"vit_l_32: result {key}")
    check(bool(torch.isfinite(runner.state.theta).all()), "vit_l_32: finite theta")
    check(done == [1, 2], f"vit_l_32: two completed cycles, got {done}")
    theta_gb = runner.target.dim * 4 / 1e9
    check(len(ckpts) >= 3 and min(ckpts.values()) >= theta_gb,
          f"vit_l_32: per-cycle and best checkpoints, each holding theta: "
          f"{ckpts}")
    return counts["csghmc_update"]


# vit_tiny's widths, 32x32 inputs, batch 8, fp32
MINI_VIT = dict(arch=dict(patch=8, dim=64, depth=2, heads=4, mlp_dim=128,
                          image_size=32), classes=5, batch=8, steps=3)


def phase_vit_reference():
    """Three cSGHMC steps of a small ViT on the card against the same steps
    on the CPU, fp32 with TF32 off, nd = 0: element for element within
    rtol 1e-4, atol 1e-5, and the gap within 2% of the distance walked, as
    the mini ResNet.  Then one gradient with remat_policy="names" against
    the gradient with no remat, on the card."""
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.methods import base, get_runner_cls
    from bayesdll_tpu_torch.models.vit import ViT

    m = MINI_VIT
    side = m["arch"]["image_size"]
    rng = np.random.RandomState(1)
    xs = rng.randn(m["steps"], m["batch"], side, side, 3).astype(np.float32)
    ys = rng.randint(0, m["classes"], (m["steps"], m["batch"])).astype(np.int32)
    x_eval = torch.from_numpy(rng.randn(m["batch"], side, side, 3)
                              .astype(np.float32))

    def target_on(device, **kw):
        return make_flat_target(
            ViT(**m["arch"], num_classes=m["classes"], **kw), nd_size=64,
            num_classes=m["classes"], rng=torch.Generator().manual_seed(0),
            device=device)

    out = {}
    for device in REF_DEVICES:
        cfg = Config(method="csghmc", hparams=dict(HP, nd="0.0", nst="0"),
                     dataset="synthetic", backbone="vit_tiny", epochs=1,
                     batch_size=m["batch"], lr=1e-2, num_cycles=1, seed=0,
                     device=device)
        target, theta, ns = target_on(device)
        runner = get_runner_cls("csghmc")(target, theta, ns, cfg)
        runner._ensure_sched(m["steps"])
        start = theta.cpu().double()
        runner.run_steps(0, xs, ys, 0)
        logits, _ = target.forward(runner.state.theta, {}, x_eval.to(device))
        out[device] = {"theta": runner.state.theta.cpu().double(),
                       "v": runner.state.v.cpu().double(),
                       "logits": logits.cpu()}
    ref, card = (out[d] for d in REF_DEVICES)
    shown = []
    for key, s0 in (("theta", start), ("v", 0 * start)):
        p, r = card[key], ref[key]
        walked, gap = float((r - s0).norm()), float((p - r).norm())
        err = float((p - r).abs().max())
        check(walked > 0 and gap <= 2e-2 * walked
              and torch.allclose(p, r, rtol=1e-4, atol=1e-5),
              f"mini vit card vs CPU {key}: gap {gap:.3g}, walked {walked:.3g}, "
              f"max abs err {err:.3g}")
        shown.append(f"{key} gap/walked {gap / walked:.3g}, max abs err "
                     f"{err:.3g}")
    lg, lc = card["logits"], ref["logits"]
    check(bool(torch.isfinite(lg).all()) and torch.allclose(lg, lc, rtol=1e-4,
                                                            atol=1e-4),
          f"mini vit: eval logits card vs CPU {float((lg - lc).abs().max())}")

    grads = []
    for kw in ({}, dict(remat=True, remat_policy="names")):
        target, theta, _ = target_on("cuda", **kw)
        leaf = theta.requires_grad_()
        logits, _ = target.forward(leaf, {}, torch.from_numpy(xs[0]).cuda(),
                                   train=True)
        loss = base.ce_loss(logits, torch.from_numpy(ys[0]).cuda())
        grads.append(torch.autograd.grad(loss, leaf)[0])
    gerr = float((grads[1] - grads[0]).abs().max())
    check(torch.allclose(grads[1], grads[0], rtol=1e-5, atol=1e-7),
          f"mini vit: remat names gradient vs no remat: max abs err {gerr}")
    print(f"phase 3b: csghmc vit_tiny ({m['arch']}) batch {m['batch']} fp32, "
          f"{m['steps']} steps at nd=0, card vs CPU (every element within rtol "
          f"1e-4 atol 1e-5, gap <= 2% of the walk): {'; '.join(shown)}; eval "
          f"logits max abs err {float((lg - lc).abs().max()):.3g}; remat "
          f"'names' gradient vs no remat on the card: max abs err {gerr:.3g} "
          f"({'bitwise equal' if gerr == 0 else 'within rtol 1e-5'})",
          flush=True)


def phase_vit_steps(smi, runner, xs, ys):
    """ViT-L/32's step without remat and with remat_policy="names" (the
    setting the JAX sweep ran), on the run's batches already on the card;
    each with its profile."""
    from bayesdll_tpu_torch.models import create_backbone

    out = {"vit_l_32": big_step_time(smi, "vit_l_32", runner, xs, ys,
                                     VIT_STEPS, VIT_STEPS)}
    # the same runner through a module built with remat: the module holds
    # no weights, so only the forward changes and the peaks compare
    cfg, target = runner.cfg, runner.target
    model, _, _ = create_backbone("vit_l_32", num_classes=cfg.num_classes,
                                  **dict(cfg.backbone_kw(), remat=True,
                                         remat_policy="names"))
    runner.target = dataclasses.replace(target, module=model)
    try:
        out["vit_l_32 remat names"] = big_step_time(
            smi, "vit_l_32 remat names", runner, xs, ys, VIT_STEPS, VIT_STEPS)
    finally:
        runner.target = target
    return out


def phase_vit_b_16(smi, cfg, nd_size, sched, xs, ys):
    """ViT-B/16 (197 tokens) at batch 128, with the ViT-L/32 run's config
    and batches, alone on the card."""
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models import create_backbone

    cfg = dataclasses.replace(cfg, backbone="vit_b_16")
    model, _, _ = create_backbone("vit_b_16", num_classes=cfg.num_classes,
                                  **cfg.backbone_kw())
    target, theta, ns = make_flat_target(
        model, nd_size=nd_size, num_classes=cfg.num_classes,
        rng=torch.Generator().manual_seed(0), device="cuda")
    runner = get_runner_cls("csghmc")(target, theta, ns, cfg)
    runner.sched = sched
    return big_step_time(smi, "vit_b_16", runner, xs, ys, VIT_STEPS,
                         VIT_STEPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    smi = phase_device()
    mlp_target = full_width_target(nd_size=1000)[0]
    resnet, resnet_loaders = resnet_runner()
    errs = {"csghmc_update": max(phase_kernels(mlp_target, "mlp_mnist"),
                                 phase_kernels(resnet.target, "resnet101")),
            **phase_sg_kernels()}
    runners, by_path = {}, {}
    for method, hp, lr, kernel in PATHS:
        runner, loaders, n = phase_path(method, hp, lr, kernel)
        runners[method] = (runner, loaders)
        by_path[f"{method} mlp_mnist"] = {kernel: n}
    by_path["csghmc resnet101"] = {
        "csghmc_update": phase_resnet_path(resnet, resnet_loaders)}
    phase_reference("csghmc", HP)
    phase_reference("sgld", SG_HP, momentum=0.5)
    phase_reference("sghmc", SG_HP, momentum=0.5)
    phase_resnet_reference("csghmc", HP)
    phase_resnet_reference("sgld", SG_HP)
    times = {"mlp_mnist": kernel_times_at(smi, mlp_target),
             "resnet101": kernel_times_at(smi, resnet.target,
                                          ("csghmc_update",))}
    for method in ("csghmc", "sghmc"):
        phase_step_time(smi, method, *runners[method])
    phase_mlp_bf16_step_time(smi)
    phase_resnet_step_time(smi, resnet, resnet_loaders)
    del resnet, resnet_loaders, runners, runner, loaders
    free_device()

    # this slice: ViT-L/32, alone on the card
    vit, vit_loaders = vit_runner()
    errs["csghmc_update"] = max(errs["csghmc_update"],
                                phase_kernels(vit.target, "vit_l_32"))
    free_device()
    by_path["csghmc vit_l_32"] = {
        "csghmc_update": phase_vit_path(vit, vit_loaders)}
    phase_vit_reference()
    times["vit_l_32"] = kernel_times_at(smi, vit.target)
    xs, ys = device_batches(vit_loaders[0])
    phase_vit_steps(smi, vit, xs, ys)
    cfg, nd_size, sched = vit.cfg, vit.target.nd_size, vit.sched
    del vit, vit_loaders
    free_device()
    phase_vit_b_16(smi, cfg, nd_size, sched, xs, ys)

    # each kernel's launches and times on its main path: this slice's
    # ViT-L/32 path for csghmc_update, the SGLD and SGHMC paths for the
    # others; every D each was timed at under "times_by_path"
    main_path = {"csghmc_update": ("csghmc vit_l_32", "vit_l_32"),
                 "sgld_update": ("sgld mlp_mnist", "mlp_mnist"),
                 "sghmc_update": ("sghmc mlp_mnist", "mlp_mnist")}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"bayesdll_tpu_torch/csrc/{name}.cu",
        "replaces": f"bayesdll_tpu/ops/pallas_kernels.py:{REPLACES[name]}",
        "launches": by_path[main_path[name][0]][name],
        "max_abs_err": errs[name], **times[main_path[name][1]][name],
        "library_ms": None,
        "launches_by_path": {p: c[name] for p, c in by_path.items()
                             if name in c},
        "times_by_path": {p: t[name] for p, t in times.items() if name in t},
    } for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
