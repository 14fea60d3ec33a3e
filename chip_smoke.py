#!/usr/bin/env python3
"""Smoke test of the PyTorch port (bayesdll_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases, one line each:
  1. the card (nvidia-smi name and power limit), the kernel build from
     bayesdll_tpu_torch/csrc (one nvcc per source, all started together),
     fp32 matmuls and convolutions pinned (TF32 off);
  2. every kernel (csghmc_update, sgld_update, sghmc_update, philox_draw;
     adam_sghmc_update in phases 4 and 6e)
     against its plain PyTorch version at the main paths' shapes
     (full-width mlp_mnist: D = 2,797,568; csghmc_update also at
     ResNet-101's D = 42,576,896 and ViT-L/32's D = 305,549,312), with its
     noise checked against the closed form (philox_draw's draws against
     their moments, phase 6e);
  3. the paths: cSGHMC, SGLD, SGHMC and cSGLD training of the full-width
     MNIST MLP (784 -> 3x1000 -> 10) on synthetic data, batch 128, 2
     epochs; the other seven methods (Adam-SGHMC, Adam-cSGHMC with cold
     restarts, cSGHMC-FS, vanilla, VI, MC-dropout, Laplace) on the same MLP
     with the JAX package's smoke-matrix settings (batch 64); cSGHMC
     training of the full-width ResNet-101 (37 classes, bf16 forward,
     batch 256, 224x224x3 synthetic images); Laplace on the full-width
     ResNet-50 (bf16, batch 32, its per-example Fisher over every training
     image); and cSGHMC training of the full-width ViT-L/32 (37 classes,
     bf16 forward through the whole-vector cast, batch 128, 224x224x3
     synthetic images, checkpoints written to a temporary directory), all
     through the entry points a user calls, every kernel's launches counted
     from 0 just before each run and read just after; then small runs on
     the card held against the same runs on the CPU (MLP width 32 for
     every method but cSGLD and cSGHMC-FS, VI and MC-dropout with the same
     draws on both; a ResNet with one bottleneck per stage, and its
     vmapped Fisher against the one-example loop; vit_tiny, and its remat
     gradient); multi-chain runs (MultiChainRunner, 2 chains): all eleven
     methods on the full-width MLP with the JAX smoke matrix's settings,
     the JAX package's two big smokes (2-chain cSGHMC with the GMM
     predictive and 2-chain Laplace on the full-width ResNet-50, bf16,
     batch 32) through the port's CLI, and width-32 cSGHMC and SGHMC runs
     whose every chain equals, bit for bit, the single-chain run from its
     initial state, batches and seed;
  4. each kernel's time with CUDA events, L2 flushed before each launch,
     its plain version's and its bound, at each main path's D (all four
     update kernels at ViT-L/32's; adam_sghmc_update beside the eager
     composition it replaced).  The training steps' times and profiles are the
     benchmark's (BENCHMARK.json, benchmark/), not this script's;
  6. the fused path (fused_steps: segments of steps as replays of a
     captured CUDA graph, methods/graphed.py), fp32 with TF32 off: (a) all
     eleven methods (cSGHMC, SGLD, SGHMC, cSGLD, vanilla, Laplace's stage
     1, cSGHMC-FS, VI and MC-dropout, whose step draws through
     philox_draw, and Adam-SGHMC and Adam-cSGHMC, whose step is one
     adam_sghmc_update pass) through `train` on the full-width MLP,
     each in its phase-3 config and bitwise equal to that per-step run
     (state, counts, Adam's t, losses), noise on; (c) the eleven at 2
     chains, each chain bitwise equal to the per-step 2-chain run; (d)
     ViT-L/32 cSGHMC (bf16, batch 128) fused through `train`, its losses
     against the spread of two per-step runs;
     ViT-L/32 Adam-cSGHMC fused in segments of 3, its losses against two
     per-step runs; (e) each update kernel at the MLP's and ViT-L/32's D,
     (seed, step, gate) read from its int64 row at points past 2^63 and
     2^32, against its plain version handed the kernel's normals;
     philox_draw against its plain version (uniforms bitwise, normals
     against float64 Box-Muller and against the kernel's own fp32
     arithmetic run in torch ops, bitwise or within an ulp), its moments,
     the independence of its streams, and its time beside torch.randn and
     torch.rand; and a profiler trace of one replayed MLP segment of 10
     steps: each kernel 10 times on the card, one cudaGraphLaunch per step
     and no matrix product dispatched on the host.
  7. the real-data paths, on fixtures written from a seed into a temporary
     directory under build/: (a) the card's host (cores, PIL, g++), the
     native preprocessing library built from bayesdll_tpu_torch/native
     (it must be available), held against numpy on seeded images and timed
     per 500x375 image beside PIL's eval transform; (b) a full-size
     CIFAR-100 (50,000 + 10,000 images of learnable grating classes)
     through the pretraining CLI's main at its defaults (cSGHMC,
     ResNet-101, batch 256, lr 0.1, momentum 0.9), 1 epoch per step and
     1 fused, bit for bit equal (cuDNN deterministic), csghmc_update
     launched once a step, finite loss and NLL, per-epoch ms/step, images/s
     and training error, the CIFAR loader's images/s alone; a
     mini ResNet on the fixture cut to 256 images, card against CPU; (c)
     where PIL imports, a Pets-layout fixture (512 + 256 JPEGs at 500x375)
     through demo_vision's main (pets, resnet101, batch 128), fp32 and bf16,
     each epoch profiled, and ImageFileLoader's images/s alone.
  8. checkpoints and traces, run after the ViT-L/32 path and before the
     fused ViT phases hold their graph pools: (a) the trained ViT-L/32
     cSGHMC state (4.89 GB) through utils/checkpoint.py's DCP directory
     and through the pickle payload, each restored on the card bitwise
     with its counts, one more step from the original and from each
     restore bitwise equal (csghmc_update once each), the seconds, GB/s
     and bytes on disk of each save and restore, the files deleted; (b)
     2-chain cSGHMC on the full-width MLP through the CLI with
     --ckpt_backend orbax, 1 epoch and a --resume from chains_ckpt_orbax
     to 2 epochs bitwise equal to the uninterrupted run (states, counts,
     bi, cycle registries), the pickle's resume bitwise equal to it, per
     step and fused, launches = steps x chains, and epoch 1 again in the
     uninterrupted run's runner after an in-place directory load (its
     graphs replayed) and after a pickle load (captured again); (c)
     `cli.demo --profile_dir` on the MLP cSGHMC path for an epoch, per
     step and fused: the trace names csghmc_update_kernel once a step,
     launches = steps, and the program file beside it holds the epoch and
     its steps (ids 0..n-1) on the trace's clock, each csghmc_update
     launch inside an `update` span (fused: inside a `fused.segment`).
  9. multi-device (parallel/): (a) each of the four kernels on 2 and 4
     shards of the MLP's and of ViT-L/32's D at their global offsets
     (`elem0`), bitwise equal to one whole-vector launch, one launch per
     shard; (b) the process-group path in a world of one rank over NCCL
     (`--multihost`, a ('chain', 'data') mesh, the gradient's all-reduce,
     the losses' gathers): 2-chain cSGHMC on the full-width MLP through the
     CLI and ViT-L/32 cSGHMC (bf16, batch 128) with --fsdp, each bitwise
     equal to the single-process run per step and fused; (c) two ranks
     sharing the card over gloo (NCCL refuses two ranks on one GPU), each a
     CLI process with --multihost:
     the MLP with --data_parallel 2 at nd = 0 against the single step,
     with --fsdp bitwise equal to replicated data parallel at nd > 0 (half
     of D per rank), --num_chains 2 over the ranks bitwise the
     single-process chains, a DCP save and resume at world 2 bitwise, and
     ViT-L/32 at --tensor_parallel 2 for 2 steps against the
     single-process steps; (d) the DCP directory restored at another
     layout: the MLP's 2 chains saved by the two ranks with
     --data_parallel 2 --fsdp after an epoch and resumed through the CLI
     in this process without --fsdp, the restore bitwise the ranks' states
     and the resumed epoch bitwise the pickle's resume; the ViT-L/32 chain
     saved by 2 fsdp ranks and restored in this process, each rank's
     slice bitwise, with seconds and GB/s; (e) the tensor-parallel
     ViT-L/32 ranks of (c), after their run, 2 steps from one state
     without remat (twice), with remat "" and "names": losses and θ
     against the plain run's, the all-reduces per step, the peak memory;
     and Laplace's stage-2 Fisher of a ViT-B/16-width model at depth 2
     under --tensor_parallel 2 against this process's; every rank process
     ends with the phase;
  10. SwinV2's window attention (csrc/window_attention.cu), after the ViT
     phases: at the three shapes of swinv2_l_w24_384.sample (batch 64, N
     576 shifted with 16 windows of 6 heads, N 576 global with 24 heads, N
     144 with 48 heads; d 32, bf16) forward and backward against the plain
     version in fp32, each gap of o, dq, dk, dv and dBias no larger than
     1.01 x SDPA's (memory-efficient kernels, the mask in the bias) on the
     same inputs, two runs bit for bit; each kernel's time, and the
     operator's fwd + bwd against its bound, the plain version's and
     SDPA's, less than SDPA's over a step's blocks; the four kernels'
     launches in one step of the SwinV2-L cSGHMC runner (24 each).
The MLP and ResNet runners are freed before the ViT-L/32 phases.  The
script prints its total time; the line before the last is a JSON record of
the kernels; the last line is {"ok": true, "device": {...}}.  Any failure
raises, and the script exits non-zero with no result line; with no CUDA
card it stops at once.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# the H100 SXM peaks (fp32 outside the tensor cores, bf16 dense on them)
from bayesdll_tpu_torch.utils.profiling import BF16_PEAK, FP32_PEAK

HP = {"prior_sig": "1.0", "Ninflate": "1.0", "nd": "1.0", "thin": "2",
      "bias": "informative", "nst": "2", "momentum_decay": "0.05"}
SG_HP = dict(HP, burnin="1")  # SGLD and SGHMC: moments from epoch 1 on
LR_SG = 1e-2  # SGLD, SGHMC and cSGLD (see PATHS)
TOL = dict(rtol=1e-6, atol=1e-6)  # as tests/test_pallas_kernels.py


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

# the JAX package's ViT bench (tools/big_model_bench.py as tools/hw_sweep.sh
# runs it): cSGHMC on vit_l_32, 37 classes (Pets), batch 128, bf16 forward
# on an fp32 theta, the bench's hparams, 2 cycles; synthetic data, 6 epochs
# of 3 steps, evaluated every 5th epoch (the last included).  lr 1e-3 in
# place of the bench's 1e-2, at which the run does not fit (PERF.md section
# 4 gives the sweep).  Unlike the ResNet, the ViT tells the synthetic
# classes apart (a position-wise linear readout of the patches suffices),
# so the run is held to its test error as well as its training error.  The
# run had 16 epochs until the fused phases came; 6 keep two cycles, the
# last epoch's evaluation and four checkpoint writes of 8.6-12.2 GB, where
# 16 wrote six, and leave room for the fused path's ViT-L/32 runs.
VIT = dict(backbone="vit_l_32", num_classes=37, batch_size=128,
           compute_dtype="bfloat16", epochs=6, num_cycles=2,
           test_eval_freq=5)
VIT_HP = dict(HP)
VIT_LR = 1e-3
VIT_ERR = 0.5  # last epoch's training error and the test error, vs 0.973
VIT_PARAMS = 305_548_325
VIT_DIM = 305_549_312
# steps of the Adam-cSGHMC runs held fused against per step (phase 6d)
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


def csghmc_kernel(args, *, nd, gate, n_eff, seed=7, step=11):
    """csghmc_update on copies of args = (g, theta, v, lr), its (seed, step,
    gate) row from the host values; returns (theta', v')."""
    from bayesdll_tpu_torch.ops import kernels
    g, th, v, lr = (t.clone() for t in args)
    kernels.csghmc_update(
        g, th, v, lr, kernels.dev_scalars(seed, step, gate), prior_sig=1.0,
        alpha=0.05, noise_pref=kernels.noise_prefactor(nd, 0.05, n_eff))
    return th, v


def phase_kernels(target, label: str):
    """csghmc_update against its plain version at `target`'s D: bitwise at
    nd = 0, the noise against its closed form."""
    from bayesdll_tpu_torch.ops import fused, kernels
    g, theta, v, lr = csghmc_inputs(target)
    kw = dict(prior_sig=1.0, alpha=0.05)
    n_eff = 1000.0

    def kern(nd, gate, seed=7, step=11, a=(g, theta, v, lr)):
        return csghmc_kernel(a, nd=nd, gate=gate, n_eff=n_eff, seed=seed,
                             step=step)

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
                              kernels.dev_scalars(7, 11), noise_pref=0.0,
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
# the update kernels' Philox stream ids (csrc/normal_from_bits.cuh)
KERNEL_STREAM = {"csghmc_update": 0, "sgld_update": 1, "sghmc_update": 2}


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
    out = getattr(kernels, name)(*(t.clone() for t in args),
                                 kernels.dev_scalars(seed, step),
                                 prior_sig=1.0, n_eff=n_eff, nd=nd,
                                 **SG_ALPHA[name])
    return out if isinstance(out, tuple) else (out,)


def sg_plain(name, args, *, nd, n_eff, noise=None, generator=None):
    from bayesdll_tpu_torch.ops import fused
    out = getattr(fused, name)(*args, prior_sig=1.0, n_eff=n_eff, nd=nd,
                               noise=noise, generator=generator,
                               **SG_ALPHA[name])
    return out if isinstance(out, tuple) else (out,)


def sg_noise_std(name, nd, n_eff, lr):
    """Closed-form std of the injected term: nd sqrt(2/(N lr)) for sgld,
    nd sqrt(2 alpha/(N lr)) for sghmc."""
    return nd * math.sqrt(2.0 * SG_ALPHA[name].get("alpha", 1.0) / (n_eff * lr))


# Adam-SGHMC's pass (csrc/adam_sghmc_update.cu) at the smoke matrix's Adam
# hparams and Adam step 7, in two of its forms: Adam-cSGHMC's with the SGD
# step in the pass (torch-SGD momentum 0, the benchmark's), temperature
# 0.5; Adam-SGHMC's leaving SGD's gradient g + v_mom' over g for the eager
# step (a nonzero momentum)
ADAM_KW = dict(prior_sig=1.0, alpha=0.05, beta1=0.9, beta2=0.999,
               eps_adam=1e-8)
ADAM_T = 7
ADAM_FORMS = {"adam_csghmc": dict(add_g=False, sgd_step=True,
                                  temperature=0.5),
              "adam_sghmc": dict(add_g=True, sgd_step=False)}


def adam_inputs(target, lr_body=1e-2, lr_head=2e-2):
    """(g, theta, theta0, v_mom, m, v2, mask, lr) at D: sg_inputs' vectors
    and Adam's two moments."""
    g, theta, theta0, v, mask, lr = sg_inputs(target, lr_body, lr_head)
    gen = torch.Generator(device="cuda").manual_seed(3)
    m = 0.01 * torch.randn(target.dim, generator=gen, device="cuda")
    v2 = (1e-3 * torch.randn(target.dim, generator=gen, device="cuda")).abs_()
    return g, theta, theta0, v, m, v2, mask, lr


def adam_bc_row():
    from bayesdll_tpu_torch.ops import fused, kernels
    return kernels.bias_row(*fused.adam_bias_corrections(
        ADAM_T, ADAM_KW["beta1"], ADAM_KW["beta2"]))


def adam_kernel(args, form, *, nd, n_eff, dev, copy=True):
    """The kernel on `args` (on copies of them with `copy`); returns what
    the form writes: (g, theta, v_mom, m, v2)."""
    from bayesdll_tpu_torch.ops import kernels
    g, theta, theta0, v_mom, m, v2, mask, lr = \
        (t.clone() for t in args) if copy else args
    kernels.adam_sghmc_update(g, theta, theta0, v_mom, m, v2, mask, lr,
                              adam_bc_row(), dev, n_eff=n_eff, nd=nd,
                              **ADAM_KW, **ADAM_FORMS[form])
    return g, theta, v_mom, m, v2


def adam_plain(args, form, *, nd, n_eff, noise=None, copy=True):
    """The eager composition the kernel replaces (adam_sghmc_momentum,
    then sgd_step at momentum 0 or SGD's gradient over g), on `args` or
    copies of them, with the kernel's host bias corrections; returns the
    same five."""
    from bayesdll_tpu_torch.core.sgd import sgd_step
    from bayesdll_tpu_torch.ops import fused
    g, theta, theta0, v_mom, m, v2, mask, lr = \
        (t.clone() for t in args) if copy else args
    f = dict(ADAM_FORMS[form])
    add_g, step = f.pop("add_g"), f.pop("sgd_step")
    fused.adam_sghmc_momentum(g, theta, theta0, v_mom, m, v2, ADAM_T, mask,
                              lr, n_eff=n_eff, nd=nd, noise=noise, **ADAM_KW,
                              **f)
    grad = g.add_(v_mom) if add_g else v_mom
    if step:
        sgd_step(theta, grad, None, lr, 0.0, ADAM_T - 1)
    return g, theta, v_mom, m, v2


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
            getattr(kernels, name)(*(t[1:] for t in args),
                                   kernels.dev_scalars(7, 11), prior_sig=1.0,
                                   n_eff=n_eff, nd=0.0, **SG_ALPHA[name])
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


def fresh_loaders(loaders):
    """New loaders over the same examples as `loaders` (train, val, test),
    each from its first epoch again: what prepare(cfg) gives for the same
    cfg, without generating the synthetic set anew."""
    from bayesdll_tpu_torch.data import ArrayLoader
    return [None if ld is None else ArrayLoader(
        ld.x, ld.y, ld.batch_size, shuffle=ld.shuffle, seed=ld._seed,
        drop_last=ld.drop_last) for ld in loaders]


def make_runner(cfg, width=None, depth=None, workdir=None, loaders=None):
    """The runner and loaders of `cfg` through prepare (or fresh copies of
    `loaders`, a run of the same data settings), create_backbone,
    make_flat_target and get_runner_cls, with the cold-restart re-init
    function wired as the CLI wires it."""
    from bayesdll_tpu_torch.cli.demo import make_reinit_fn
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.data import prepare
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models import create_backbone
    if loaders is None:
        *loaders, nd = prepare(cfg)
    else:
        loaders = fresh_loaders(loaders)
        nd = loaders[0].num_examples
    kw = {} if width is None else dict(width=width, depth=depth)
    model, _, meta = create_backbone(cfg.backbone, num_classes=cfg.num_classes,
                                     **cfg.backbone_kw(), **kw)
    target, theta, ns = make_flat_target(
        model, nd_size=nd, num_classes=cfg.num_classes,
        rng=torch.Generator().manual_seed(cfg.seed),
        has_batch_stats=meta["has_batch_stats"], device=cfg.device)
    runner = get_runner_cls(cfg.method)(target, theta, ns, cfg,
                                        workdir=workdir)
    if hasattr(runner, "set_reinit_fn"):
        runner.set_reinit_fn(make_reinit_fn(model, target, cfg.seed))
    return runner, loaders


def reset_launches():
    """Every kernel's launch count to 0, the window-attention kernels'
    too."""
    from bayesdll_tpu_torch.ops import kernels
    kernels.set_launch_counts(dict.fromkeys(kernels.launch_counts(), 0))


def read_launches() -> dict:
    from bayesdll_tpu_torch.ops import kernels
    return kernels.launch_counts()


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


def state_field(runner, name) -> torch.Tensor:
    """A field of the runner's state, or else of the runner (LA's
    post_vars)."""
    return getattr(runner.state, name) if hasattr(runner.state, name) \
        else getattr(runner, name)


def phase_reference(method, hp, momentum=0.0, lr=2e-2, fields=("theta",),
                    in_norm=(), hand=None):
    """A small run on the card against the same run on the CPU (nd = 0: no
    noise, so the two agree up to fp32 rounding): each of `fields` element
    for element within rtol 1e-4, atol 1e-5; those in `in_norm` as the mini
    ResNet's, within 2% of the distance walked with 99% of the elements
    that close.  `hand(runner, device)` hands both runs the same draws."""
    from bayesdll_tpu_torch.config import Config

    out = {}
    for device in REF_DEVICES:
        cfg = Config(method=method, hparams=dict(hp, nd="0.0", nst="0"),
                     dataset="synthetic", backbone="mlp_mnist", epochs=2,
                     batch_size=64, lr=lr, momentum=momentum, num_cycles=2,
                     seed=0, val_heldout=0.15, device=device)
        cfg.synthetic_n_train = 512
        cfg.synthetic_n_test = 256
        runner, loaders = make_runner(cfg, width=32, depth=2)
        if hand is not None:
            hand(runner, device)
        start = {f: state_field(runner, f).cpu().double() for f in in_norm}
        res = runner.train(*loaders)
        out[device] = (res, {f: state_field(runner, f).cpu().double()
                             for f in fields + in_norm})
    (rc, tc), (rg, tg) = (out[d] for d in REF_DEVICES)
    shown = []
    for f in fields:
        err = float((tg[f] - tc[f]).abs().max())
        check(torch.allclose(tg[f], tc[f], rtol=1e-4, atol=1e-5),
              f"{method}: card vs CPU {f} after training: max abs err {err}")
        shown.append(f"{f} max abs err {err:.3g}")
    for f in in_norm:
        p, r = tg[f], tc[f]
        walked, gap = float((r - start[f]).norm()), float((p - r).norm())
        close = float(((p - r).abs() <= 1e-5 + 1e-4 * r.abs()).double().mean())
        check(walked > 0 and gap <= 2e-2 * walked and close >= 0.99,
              f"{method}: card vs CPU {f}: gap {gap:.3g}, walked {walked:.3g}, "
              f"{close:.4%} within rtol 1e-4 atol 1e-5")
        shown.append(f"{f} gap/walked {gap / walked:.3g}, {close:.4%} of "
                     "elements within rtol 1e-4 atol 1e-5")
    for key in ("nll", "ece"):
        check(abs(rg[key] - rc[key]) < 1e-3, f"{method}: card vs CPU {key}")
    print(f"phase 3b: {method} width-32 run, momentum {momentum}, card vs CPU: "
          f"{'; '.join(shown)} (rtol 1e-4, atol 1e-5); nll "
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
        runner.step_loop(0, xs, ys, 0)
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
                  "sghmc_update": 32,   # read g, theta, theta0, v, mask, lr; write g, v
                  # read g, theta, theta0, mask, lr, v_mom, m, v2; write
                  # v_mom, m, v2, theta (Adam-cSGHMC's form at momentum 0)
                  "adam_sghmc_update": 48}
# operations per element, all counted at the fp32 rate (a generous bound:
# integer ops run slower): the update's arithmetic plus ~35 for a quarter of
# a Philox call and half a Box-Muller pair
OPS_PER_ELEM = {"csghmc_update": 45, "sgld_update": 45, "sghmc_update": 50,
                "adam_sghmc_update": 60}


def kernel_times_at(smi, target, names=(*REPLACES, "adam_sghmc_update")):
    """Each kernel in `names` cold against its bound and its plain version
    at `target`'s D, the operands freed before the next.  Every launch reads
    one row (seed 0, step 1, the gate on or off), made before the timing:
    a launch's time does not depend on the values."""
    from bayesdll_tpu_torch.ops import fused, kernels
    flush = torch.zeros(64 * 2**20, device="cuda")  # 256 MB, 5x the L2
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {on: kernels.dev_scalars(0, 1, on) for on in (False, True)}
    out = {}
    kw = dict(prior_sig=1.0, alpha=0.05)
    d = target.dim
    n_eff = float(target.nd_size)

    if "csghmc_update" in names:
        g, theta, v, lr = csghmc_inputs(target, lr_body=1e-4, lr_head=2e-4)
        pref = kernels.noise_prefactor(1.0, kw["alpha"], n_eff)

        def csghmc(gate):
            kernels.csghmc_update(g, theta, v, lr, rows[gate],
                                  noise_pref=pref, **kw)

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
            getattr(kernels, name)(*args, rows[True], prior_sig=1.0,
                                   n_eff=n_eff, nd=1.0 if noise else 0.0,
                                   **SG_ALPHA[name])

        out[name] = kernel_times(
            smi, name, sg,
            lambda name=name, args=args: sg_plain(name, args, nd=1.0,
                                                  n_eff=n_eff, generator=gen),
            BYTES_PER_ELEM[name] * d, OPS_PER_ELEM[name] * d, flush,
            "nd = 0, no draw")
    del vecs
    free_device()

    if "adam_sghmc_update" in names:
        # Adam-cSGHMC's form; the plain version is the eager composition
        # the kernel replaced: philox_draw's Adam-stream draw, then the
        # ~27 kernels of adam_sghmc_momentum and sgd_step's two
        args = adam_inputs(target, lr_body=1e-4, lr_head=2e-4)

        def adam(noise):
            adam_kernel(args, "adam_csghmc", nd=1.0 if noise else 0.0,
                        n_eff=n_eff, dev=rows[True], copy=False)

        def eager():
            z = fused.draw_(args[0], kind="normal",
                            stream=kernels.STREAM_ADAM, dev=rows[True])
            adam_plain(args, "adam_csghmc", nd=1.0, n_eff=n_eff, noise=z,
                       copy=False)

        out["adam_sghmc_update"] = kernel_times(
            smi, "adam_sghmc_update", adam, eager,
            BYTES_PER_ELEM["adam_sghmc_update"] * d,
            OPS_PER_ELEM["adam_sghmc_update"] * d, flush, "nd = 0, no draw")
        del args
    for t in out.values():
        t["dim"] = d
    del flush
    free_device()
    return out


def free_device():
    """Hand the caching allocator's free blocks back, so the next phase's
    peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def device_batches(loader):
    """The loader's batches, copied to the card once."""
    return ([torch.from_numpy(x).cuda() for x, _, _ in loader],
            [torch.from_numpy(y).cuda() for _, y, _ in loader])


def _self_device(e) -> float:
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


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
        runner.step_loop(0, xs, ys, 0)
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


# swinv2_l_w24_384.sample's window attention at batch 64, head width 32,
# bf16: (windows, heads, N, (grid, window, shift) of a shifted block's
# regions or None, blocks of a step at that shape: stage 1's two, one of
# them unshifted of the same size, and stage 2's two count as three)
WINDOW_SHAPES = {"n576_shifted": (16, 6, 576, (96, 24, 12), 3),
                 "n576_global": (1, 24, 576, None, 18),
                 "n144_global": (1, 48, 144, None, 2)}
WINDOW_BATCH = 64
WINDOW_NAMES = ("o", "dq", "dk", "dv", "dbias")


def window_inputs(w, h, n, regions, seed):
    """q (normalised, times 10), k (normalised), v and dO in bf16 on the
    card, the bias 16 sigmoid(randn) [h, n, n] in fp32 at values bf16 holds
    (so the kernels, SDPA and the fp32 plain version read one bias), and
    the int32 region labels (or None)."""
    from bayesdll_tpu_torch.models import swinv2
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (WINDOW_BATCH, w, h, n, 32)

    def randn(*sh):
        return torch.randn(*sh, generator=g, device="cuda")
    q = torch.nn.functional.normalize(randn(*shape), dim=-1) * 10.0
    k = torch.nn.functional.normalize(randn(*shape), dim=-1)
    v, do = randn(*shape), randn(*shape)
    bias = (16.0 * torch.sigmoid(randn(h, n, n))).bfloat16().float()
    lab = None if regions is None else swinv2.window_regions(*regions).cuda()
    return [t.bfloat16() for t in (q, k, v)], bias, lab, do.bfloat16()


def window_grads(fn, qkv, bias, lab, do):
    """o and the gradients of q, k, v and the bias of sum(o dO)."""
    leaves = [t.detach().clone().requires_grad_() for t in (*qkv, bias)]
    o = fn(*leaves[:3], leaves[3], lab)
    return [o.detach(), *torch.autograd.grad((o.float() * do.float()).sum(),
                                             leaves)]


def window_sdpa(q, k, v, bias, lab):
    """The library yardstick: SDPA as the port called it before, the
    windows folded into the heads and the mask added to the bias in q's
    dtype."""
    from bayesdll_tpu_torch.ops.window_attention import region_mask
    b, w, h, n, d = q.shape
    mask = bias[None] if lab is None else bias[None] + region_mask(lab)[:, None]
    mask = mask.expand(w, h, n, n).reshape(1, w * h, n, n).to(q.dtype)
    o = torch.nn.functional.scaled_dot_product_attention(
        *(t.reshape(b, w * h, n, d) for t in (q, k, v)), attn_mask=mask,
        scale=1.0)
    return o.view(b, w, h, n, d)


def window_plain(qkv, bias, lab, do, chunk=8):
    """The plain version's o and gradients in fp32, over batch chunks."""
    from bayesdll_tpu_torch.ops.window_attention import window_attention_plain
    outs = [window_grads(window_attention_plain,
                         [t[i:i + chunk].float() for t in qkv], bias, lab,
                         do[i:i + chunk].float())
            for i in range(0, WINDOW_BATCH, chunk)]
    return ([torch.cat([o[j] for o in outs]) for j in range(4)]
            + [sum(o[4] for o in outs)])


def window_kernel_ms(qkv, bias, lab, do) -> dict:
    """Each of the four kernels alone, back to back (ms a launch), on the
    operands the autograd Function hands them."""
    from bayesdll_tpu_torch.ops import window_attention as wa
    q, k, v = (t.contiguous() for t in qkv)
    do = do.contiguous()
    b, w, h, n, _ = q.shape
    bias_k = bias.to(q.dtype).contiguous()
    bias_t = bias_k.transpose(1, 2).contiguous()
    o, dq, dk, dv = (wa._rows_like(q) for _ in range(4))
    lse = torch.empty(b, w, h, n, device="cuda")
    delta = torch.empty_like(lse)
    dbias = torch.empty(h, n, n, device="cuda")
    bwd = dict(k=k, v=v, dout=do, lse=lse, delta=delta)
    calls = {
        "window_attn_fwd": lambda: wa._launch(
            "window_attn_fwd", q, bias_k, lab, k=k, v=v, out0=o, lse=lse),
        "window_attn_bwd_dq": lambda: wa._launch(
            "window_attn_bwd_dq", q, bias_k, lab, o=o, out0=dq, **bwd),
        "window_attn_bwd_dkdv": lambda: wa._launch(
            "window_attn_bwd_dkdv", q, bias_t, lab, out0=dk, out1=dv, **bwd),
        "window_attn_dbias": lambda: wa._launch(
            "window_attn_dbias", q, bias_k, lab, dbias=dbias, **bwd)}
    saved = wa.launch_counts()
    out = {name: cuda_ms(fn, 10) for name, fn in calls.items()}
    wa.set_launch_counts(saved)
    return out


def swinv2_step_launches() -> dict:
    """The launches of one step of the SwinV2-L cSGHMC runner (the
    benchmark cell's model, bf16, batch 64, synthetic 384x384 images),
    every count set to 0 just before and read just after."""
    from bayesdll_tpu_torch.config import Config
    cfg = Config(method="csghmc", hparams=dict(HP), dataset="synthetic",
                 backbone="swinv2_l_w24_384", num_classes=37,
                 batch_size=WINDOW_BATCH, compute_dtype="bfloat16", lr=1e-3,
                 epochs=1, seed=0, device="cuda")
    cfg.synthetic_n_train = 2 * WINDOW_BATCH
    cfg.synthetic_n_test = 8
    runner, loaders = make_runner(cfg)
    xs, ys = device_batches(loaders[0])
    if hasattr(runner, "_ensure_sched"):
        runner._ensure_sched(len(loaders[0]))
    reset_launches()
    loss, _ = runner.step_loop(0, xs[:1], ys[:1], 0)
    torch.cuda.synchronize()
    counts = read_launches()
    check(bool(torch.isfinite(loss).all()), "swinv2 step: a finite loss")
    del runner, loaders, xs, ys
    return counts


def phase_window_attention(smi) -> list:
    """SwinV2's window attention (csrc/window_attention.cu) at the three
    shapes of swinv2_l_w24_384.sample: forward and backward against the
    plain version in fp32, each gap of o, dq, dk, dv and dBias no larger
    than 1.01 x that of SDPA's memory-efficient kernels on the same bf16
    inputs, two runs bit for bit; the four kernels' launches in one step of
    the SwinV2-L runner; and each kernel's time, the operator's fwd + bwd
    through autograd against its bound (benchmark/swinv2_counts.py's 12
    N^2 d FLOPs and 24 N d bytes a window and head at the bf16 peak and
    the memory rate), the plain version's and SDPA's (library_ms).
    Returns the kernels' records."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from bayesdll_tpu_torch.ops import window_attention as wa
    dev = torch.cuda.get_device_name(0)
    tic = time.perf_counter()
    gaps, per_kernel, op = {}, {}, {}
    for seed, (shape, (w, h, n, regions, _)) in enumerate(
            WINDOW_SHAPES.items()):
        qkv, bias, lab, do = window_inputs(w, h, n, regions, 21 + seed)
        ref = window_plain(qkv, bias, lab, do)
        got = window_grads(wa.window_attention, qkv, bias, lab, do)
        again = window_grads(wa.window_attention, qkv, bias, lab, do)
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"window attention {shape}: two runs bit for bit")
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            lib = window_grads(window_sdpa, qkv, bias, lab, do)

        def gap(x, r):
            return float((x.double() - r.double()).norm() / r.double().norm())
        gaps[shape] = {nm: (gap(x, r), gap(y, r))
                       for nm, x, y, r in zip(WINDOW_NAMES, got, lib, ref)}
        for nm, (kg, sg) in gaps[shape].items():
            check(kg <= 1.01 * sg, f"window attention {shape} {nm}: gap "
                  f"{kg:.3e} against SDPA's {sg:.3e}")
        per_kernel[shape] = window_kernel_ms(qkv, bias, lab, do)
        problems = WINDOW_BATCH * w * h
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            library_ms = cuda_ms(
                lambda: window_grads(window_sdpa, qkv, bias, lab, do), 5)
        op[shape] = dict(
            ms=cuda_ms(lambda: window_grads(wa.window_attention, qkv, bias,
                                            lab, do), 5),
            library_ms=library_ms,
            plain_ms=cuda_ms(lambda: window_plain(qkv, bias, lab, do,
                                                  chunk=16), 1, warmup=1),
            bound_ms=max(problems * 12 * n * n * 32 / BF16_PEAK,
                         problems * 24 * n * 32 / peak_bytes_per_s(dev)) * 1e3)
        del qkv, bias, lab, do, ref, got, again, lib
        free_device()
        print(f"phase 10: [{smi}] window attention {shape} (batch "
              f"{WINDOW_BATCH}, {w} windows x {h} heads, N {n}, d 32, bf16): "
              "gaps to fp32, kernels / SDPA: " + "; ".join(
                  f"{nm} {a:.3e} / {b:.3e}" for nm, (a, b) in
                  gaps[shape].items())
              + "; kernels ms: " + ", ".join(
                  f"{k.replace('window_attn_', '')} {v:.3f}"
                  for k, v in per_kernel[shape].items())
              + f"; fwd + bwd through autograd {op[shape]['ms']:.3f} ms, "
              f"bound {op[shape]['bound_ms']:.3f} ms "
              f"({op[shape]['bound_ms'] / op[shape]['ms']:.2%}), SDPA "
              f"{op[shape]['library_ms']:.3f} ms, plain "
              f"{op[shape]['plain_ms']:.3f} ms", flush=True)
    counts = swinv2_step_launches()
    free_device()
    want = {k: 24 for k in wa.KERNELS}
    check({k: counts[k] for k in wa.KERNELS} == want,
          f"swinv2 step: window-attention launches {counts}, want 24 each")
    step = {key: sum(op[s][key] * WINDOW_SHAPES[s][4] for s in op)
            for key in ("ms", "library_ms", "plain_ms", "bound_ms")}
    check(step["ms"] < step["library_ms"],
          f"window attention: a step's blocks take {step['ms']:.2f} ms, SDPA "
          f"{step['library_ms']:.2f} ms")
    print(f"phase 10: [{smi}] one swinv2_l_w24_384 cSGHMC step, bf16, batch "
          f"{WINDOW_BATCH}: launches {counts}; a step's blocks: kernels "
          f"{step['ms']:.2f} ms, bound {step['bound_ms']:.2f} ms "
          f"({step['bound_ms'] / step['ms']:.2%}), SDPA "
          f"{step['library_ms']:.2f} ms; {time.perf_counter() - tic:.1f} s",
          flush=True)
    return [{
        "name": name, "route": "cuda",
        "source": "bayesdll_tpu_torch/csrc/window_attention.cu",
        "replaces": "none: SDPA's memory-efficient kernels "
                    "(the JAX package has no SwinV2)",
        "launches": counts[name],
        "max_gap": max(g[nm][0] for g in gaps.values() for nm in g),
        "ms": sum(per_kernel[s][name] * WINDOW_SHAPES[s][4]
                  for s in per_kernel),
        "ms_by_shape": {s: per_kernel[s][name] for s in per_kernel},
        "op_ms": step["ms"], "bound_ms": step["bound_ms"],
        "library_ms": step["library_ms"], "plain_ms": step["plain_ms"],
    } for name in wa.KERNELS]


# ---- the other seven methods ------------------------------------------------

# the JAX package's hardware smoke matrix (tools/tpu_smoke_all_methods.py):
# each method on the full-width MLP with its hparams (:24-47) and lr (:49),
# 2 epochs of batch 64 in 2 cycles.  Two deviations: Adam-cSGHMC restarts
# cold (perform_cold_restarts=1, with the CLI's re-init function), so that a
# restart runs on the card; cSGHMC-FS runs 8 epochs, since in 2 epochs of 2
# cycles its snapshot window (the 3rd- and 2nd-last epochs of each cycle) is
# empty and no model average would be taken.  method -> (hparams, lr, epochs)
SMOKE = {
    "adam_sghmc": ("prior_sig=1.0,Ninflate=1.0,nd=0.01,burnin=0,thin=2,"
                   "bias=informative,nst=2,momentum_decay=0.05,beta1=0.9,"
                   "beta2=0.999,epsilon=1e-8", 1e-3, 2),
    "adam_csghmc": ("prior_sig=1.0,Ninflate=1.0,nd=0.01,thin=2,"
                    "bias=informative,nst=2,momentum_decay=0.05,beta1=0.9,"
                    "beta2=0.999,epsilon=1e-8,temperature=1.0,"
                    "perform_cold_restarts=1", 1e-3, 2),
    "csghmc_fs": ("prior_sig=0.05,Ninflate=1.0,nd=0.01,thin=2,"
                  "bias=informative,nst=2,momentum_decay=0.05", 2e-2, 8),
    "vanilla": ("wd=1e-4,bias=penalty", 2e-2, 2),
    "vi": ("prior_sig=1.0,kld=1e-5,bias=informative,nst=2", 2e-2, 2),
    "mc_dropout": ("prior_sig=1.0,p_drop=0.1,kld=1e-5,bias=gaussian,nst=2",
                   2e-2, 2),
    "la": ("prior_sig=0.02,Ninflate=1.0,bias=informative,nst=2,"
           "fisher_microbatch=16", 2e-2, 2),
}
# Laplace at the matrix's prior_sig 0.1: stage 1 fits the set, so the
# per-example gradients at the MAP are ~0 and every variance is the prior's
# 0.01; a draw with std 0.1 on every weight of a 1000-wide layer then
# predicts at chance.  The path runs at 0.02, near the hidden layers' init
# scale (1/sqrt(1000)), and `phase_la_prior_sig` reports the matrix's 0.1.
LA_MATRIX_HP = ("prior_sig=0.1,Ninflate=1.0,bias=informative,nst=2,"
                "fisher_microbatch=16")
SMOKE_BATCH = 64
# the kernel a path's step launches; the others launch none.  VI, MC-dropout
# and the Adam methods (at nd != 0) draw a whole vector each step.
DRAWS = ("vi", "mc_dropout")
ADAM = ("adam_sghmc", "adam_csghmc")  # one adam_sghmc_update pass a step
METHOD_KERNEL = {**{m: "philox_draw" for m in DRAWS},
                 **{m: "adam_sghmc_update" for m in ADAM}}
SMOKE_KERNEL = {"csghmc_fs": "csghmc_update", **METHOD_KERNEL}
# cSGHMC-FS's snapshot epochs at 8 epochs in 2 cycles (ep % 4 in {1, 2})
FS_SNAPSHOTS = [1, 2, 5, 6]


def watch_restarts(runner) -> list:
    """Records each cycle boundary of Adam-cSGHMC: whether θ was re-drawn
    (the re-init function called, θ changed) and the sampler state zeroed."""
    seen = []
    start, reinit = runner.on_cycle_start, runner._reinit_fn
    calls = []

    def reinit_fn(cycle):
        calls.append(cycle)
        return reinit(cycle)

    def on_cycle_start(cycle):
        before = runner.state.theta.clone()
        n = len(calls)
        start(cycle)
        s = runner.state
        seen.append(dict(cycle=cycle, redrawn=len(calls) == n + 1,
                         moved=not torch.equal(s.theta, before),
                         zeroed=s.t == 0 and all(
                             float(getattr(s, k).abs().max()) == 0.0
                             for k in ("buf", "v_mom", "m", "v2"))))
    runner._reinit_fn, runner.on_cycle_start = reinit_fn, on_cycle_start
    return seen


def watch_fisher(runner) -> dict:
    """Records LA's stage 2: its time, its peak device memory, the examples
    it saw, and whether it left the running statistics as they were."""
    seen = {}
    estimate = runner.estimate_variance

    def estimate_variance(loader):
        before = tree_clone(runner.net_state.get("batch_stats", {}))
        seen["moved_in_stage1"] = any(
            not torch.equal(a, b) for a, b in zip(
                tree_leaves(before), tree_leaves(seen["stats0"])))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tic = time.perf_counter()
        out = estimate(loader)
        torch.cuda.synchronize()
        seen["secs"] = time.perf_counter() - tic
        seen["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        seen["examples"] = loader.num_examples
        seen["stats_same"] = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(before),
            tree_leaves(runner.net_state.get("batch_stats", {}))))
        return out
    seen["stats0"] = tree_clone(runner.net_state.get("batch_stats", {}))
    runner.estimate_variance = estimate_variance
    return seen


def check_post_vars(runner, what: str) -> str:
    """LA's posterior variance: finite, positive, at most prior_sig^2 (the
    Fisher only adds precision) up to rounding."""
    pv = runner.post_vars
    sig2 = runner.prior_sig ** 2
    check(bool(torch.isfinite(pv).all()), f"{what}: post_vars finite")
    lo, hi = float(pv.min()), float(pv.max())
    check(0.0 < lo and hi <= sig2 + 1e-8,
          f"{what}: 0 < post_vars <= prior_sig^2 = {sig2}: [{lo}, {hi}]")
    return (f"post_vars in [{lo:.4g}, {hi:.4g}] (prior_sig^2 {sig2:.4g}), "
            f"mean {float(pv.mean()):.4g}")


def phase_method_path(method):
    """One of the seven through `train` on the full-width MLP with the smoke
    matrix's settings, every kernel's count set to 0 just before and read
    just after; artifacts in a temporary directory, deleted after."""
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.methods.vi import S_CLAMP
    from bayesdll_tpu_torch.ops import kernels

    hp, lr, epochs = SMOKE[method]
    cfg = Config(method=method, hparams=hp, dataset="synthetic",
                 backbone="mlp_mnist", epochs=epochs, batch_size=SMOKE_BATCH,
                 lr=lr, num_cycles=2, seed=0, device="cuda")
    SCRATCH.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"{method}_", dir=SCRATCH))
    try:
        runner, loaders = make_runner(cfg, workdir=str(work))
        check(runner.target.n_params == 2_797_010, "full-width mlp_mnist")
        restarts = watch_restarts(runner) if method == "adam_csghmc" else None
        fisher = watch_fisher(runner) if method == "la" else None
        reset_launches()
        tic = time.perf_counter()
        res = runner.train(*loaders)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tic
        counts = read_launches()
        files = {p.relative_to(work).as_posix() for p in work.rglob("*")
                 if p.is_file()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    runner.workdir = None
    steps = epochs * len(loaders[0])
    want = dict.fromkeys(kernels.launch_counts(), 0)
    if method in SMOKE_KERNEL:
        want[SMOKE_KERNEL[method]] = steps
    check(counts == want, f"{method}: launches {counts}, want {want}")
    check(all(math.isfinite(x) for x in res["train_losses"]),
          f"{method}: finite losses")
    for key in ("nll", "ece", "mce"):
        check(key in res and math.isfinite(res[key]), f"{method}: result {key}")
    check(res["test_err"] < 0.5, f"{method}: test error {res['test_err']} "
          "well below chance (0.9)")
    extra = ""
    if method == "csghmc_fs":
        snaps = sorted(runner.full_samples)
        check(snaps == FS_SNAPSHOTS, f"csghmc_fs: snapshots {snaps}")
        need = {"bma_evaluation_results.pkl", "logits_test_bma.pkl",
                "collected_models/model_metadata.pkl",
                *(f"full_samples_net_ep{ep}.pkl" for ep in snaps)}
        check(need <= files, f"csghmc_fs: artifacts {sorted(files)}")
        bma = res["bma"]
        check(bma["test_ensemble_err"] < 0.5,
              f"csghmc_fs: BMA test error {bma['test_ensemble_err']}")
        extra = (f"snapshots at epochs {snaps}; BMA " + ", ".join(
            f"{k} {v:.4f}" for k, v in sorted(bma.items())))
    elif method == "adam_csghmc":
        check([r["cycle"] for r in restarts] == [2, 3]
              and all(r["redrawn"] and r["moved"] and r["zeroed"]
                      for r in restarts),
              f"adam_csghmc: a cold restart at each boundary: {restarts}")
        extra = f"boundaries {restarts}"
    elif method == "vi":
        s_ = runner.state.s_
        s = torch.clamp(s_, min=S_CLAMP)
        check(bool(torch.isfinite(s_).all()) and float(s.min()) >= S_CLAMP,
              "vi: s_ finite, s >= 1e-8")
        extra = (f"s_ in [{float(s_.min()):.4g}, {float(s_.max()):.4g}], mean "
                 f"{float(s_.mean()):.4g}")
    elif method == "la":
        extra = (f"{check_post_vars(runner, 'la mlp_mnist')}; stage 1 "
                 f"{res['map_time']:.2f} s, Fisher over {fisher['examples']} "
                 f"examples {fisher['secs']:.2f} s = "
                 f"{fisher['examples'] / fisher['secs']:.0f} examples/s")
    print(f"phase 3: [{CARD}] {method} mlp_mnist D={runner.target.dim} lr={lr} "
          f"batch {SMOKE_BATCH}, {epochs} epochs = {steps} steps in {secs:.2f} "
          f"s incl. eval; launches {counts}; losses="
          f"{[round(x, 4) for x in res['train_losses']]}; nll={res['nll']:.4f} "
          f"ece={res['ece']:.4f} mce={res['mce']:.4f} "
          f"test_err={res['test_err']:.4f}; {extra}", flush=True)
    return runner, loaders, counts


def phase_la_prior_sig():
    """Laplace on the full-width MLP at the smoke matrix's prior_sig 0.1:
    the MAP's test error and the Laplace predictive's, side by side (the
    latter not gated: see LA_MATRIX_HP)."""
    from bayesdll_tpu_torch.config import Config
    _, lr, epochs = SMOKE["la"]
    cfg = Config(method="la", hparams=LA_MATRIX_HP, dataset="synthetic",
                 backbone="mlp_mnist", epochs=epochs, batch_size=SMOKE_BATCH,
                 lr=lr, seed=0, device="cuda")
    runner, loaders = make_runner(cfg)
    res = runner.train(*loaders)
    shown = check_post_vars(runner, "la mlp_mnist prior_sig 0.1")
    post_vars, runner.post_vars = runner.post_vars, None  # the MAP predictive
    runner.state.theta = runner.map_theta
    map_loss, map_err, *_ = runner.evaluate(loaders[2])
    runner.post_vars = post_vars
    check(map_err < 0.5, f"la prior_sig 0.1: MAP test error {map_err}")
    print(f"phase 3: [{CARD}] la mlp_mnist at prior_sig 0.1: MAP test error "
          f"{map_err:.4f} (loss {map_loss:.4f}); Laplace predictive (nst=2) "
          f"test error {res['test_err']:.4f}, nll {res['nll']:.4f}; {shown}",
          flush=True)


# tools/tpu_smoke_all_methods.py:63-70 (la_multichain_fisher) on one chain:
# Laplace on resnet50 (10 synthetic classes, the CLI's default), bf16
# forward, batch 32, 1 epoch, its hparams; the Fisher in microbatches of 8
LA_RESNET = dict(backbone="resnet50", batch_size=32, compute_dtype="bfloat16",
                 epochs=1)
LA_RESNET_HP = ("prior_sig=0.1,Ninflate=1.0,bias=informative,nst=2,"
                "fisher_microbatch=8")
LA_RESNET_LR = 2e-2
RESNET50_PARAMS = 23_528_522  # at 10 classes


def phase_la_resnet50():
    """Laplace on the full-width ResNet-50 through `train`: stage 1 (MAP),
    stage 2 (the vmapped per-example Fisher over every training example,
    BatchNorm on its running statistics), the Laplace eval.  The counts set
    to 0 just before and read just after."""
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.ops import kernels

    cfg = Config(method="la", hparams=LA_RESNET_HP, dataset="synthetic",
                 lr=LA_RESNET_LR, seed=0, device="cuda", **LA_RESNET)
    runner, loaders = make_runner(cfg)
    check(runner.target.n_params == RESNET50_PARAMS,
          f"resnet50 at 10 classes: {runner.target.n_params} parameters")
    fisher = watch_fisher(runner)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tic = time.perf_counter()
    res = runner.train(*loaders)
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    counts = read_launches()
    peak_stage2 = fisher["peak_gb"]
    check(counts == dict.fromkeys(kernels.launch_counts(), 0),
          f"la resnet50: no kernel launched: {counts}")
    check(all(math.isfinite(x) for x in res["train_losses"]),
          "la resnet50: finite losses")
    for key in ("nll", "ece", "mce"):
        check(key in res and math.isfinite(res[key]), f"la resnet50: {key}")
    check(fisher["moved_in_stage1"], "la resnet50: stage 1 moved batch_stats")
    check(fisher["stats_same"], "la resnet50: stage 2 left batch_stats as "
          "they were")
    check(fisher["examples"] == loaders[0].num_examples,
          "la resnet50: the Fisher saw every training example")
    shown = check_post_vars(runner, "la resnet50")
    print(f"phase 3: [{CARD}] la resnet50 bf16 D={runner.target.dim} "
          f"({runner.target.n_params} params) batch {cfg.batch_size} lr="
          f"{cfg.lr}, {len(loaders[0])} steps: stage 1 {res['map_time']:.2f} s "
          f"incl. eval, stage 2 (Fisher, microbatch "
          f"{runner.fisher_microbatch}) {fisher['secs']:.2f} s over "
          f"{fisher['examples']} examples = "
          f"{fisher['examples'] / fisher['secs']:.1f} examples/s, peak device "
          f"memory {peak_stage2:.2f} GB in stage 2; {secs:.2f} s in all; "
          f"launches {counts}; train loss {res['train_losses']}; "
          f"nll={res['nll']:.4f} ece={res['ece']:.4f} mce={res['mce']:.4f} "
          f"test_err={res['test_err']:.4f} (chance 0.9); {shown}",
          flush=True)
    return counts


def hand_normal(runner, device):
    """VI's reparameterisation draws from one CPU generator in call order:
    the same numbers on both devices."""
    gen = torch.Generator().manual_seed(0)
    runner._train_normal = lambda step, scalars: torch.randn(
        runner.target.dim, generator=gen).to(device)


def hand_uniform(runner, device):
    """MC-dropout's uniforms (training and predictive keep-masks) from one
    CPU generator in call order: the same masks on both devices."""
    gen = torch.Generator().manual_seed(0)
    runner._uniform = lambda _generator: torch.rand(
        runner.target.dim, generator=gen).to(device)
    runner._train_uniform = lambda step, scalars: runner._uniform(None)


def phase_new_references():
    """The seven methods' small runs on the card against the CPU."""
    from bayesdll_tpu_torch.config import parse_hparams
    hp = {m: parse_hparams(SMOKE[m][0]) for m in SMOKE}
    phase_reference("vanilla", hp["vanilla"], momentum=0.5)
    phase_reference("adam_sghmc", hp["adam_sghmc"], lr=1e-3,
                    fields=("theta", "v_mom", "m", "v2"))
    phase_reference("adam_csghmc", dict(hp["adam_csghmc"],
                                        perform_cold_restarts="0"),
                    lr=1e-3, fields=("theta", "v_mom", "m", "v2"))
    phase_reference("la", parse_hparams(LA_MATRIX_HP), momentum=0.5,
                    fields=("theta", "post_vars"))
    phase_reference("vi", hp["vi"], fields=("m",), in_norm=("s_",),
                    hand=hand_normal)
    phase_reference("mc_dropout", hp["mc_dropout"], fields=("m",),
                    hand=hand_uniform)


def phase_fisher_reference():
    """LA's vmapped Fisher against the one-example loop, on the card, on the
    mini ResNet (fp32, TF32 off, BatchNorm on its running statistics):
    rtol 2e-3, as tests/test_la.py holds them.  11 examples in microbatches
    of 4: two whole ones and a remainder of 3, whose last is padding."""
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.methods import base
    from bayesdll_tpu_torch.methods.la import fisher_accumulate
    from bayesdll_tpu_torch.models.resnet import ResNet

    m = MINI
    target, theta, ns = make_flat_target(
        ResNet(m["stages"], m["classes"]), nd_size=64,
        num_classes=m["classes"], rng=torch.Generator().manual_seed(0),
        has_batch_stats=True, device="cuda")
    rng = np.random.RandomState(2)
    n = 11
    x = torch.from_numpy(rng.randn(n, m["hw"], m["hw"], 3)
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, m["classes"], n)).long().cuda()
    valid = torch.ones(n, device="cuda")
    valid[-1] = 0.0
    got = fisher_accumulate(target, theta, ns, torch.zeros_like(theta), x, y,
                            valid, 4)
    want = torch.zeros_like(theta)
    for i in range(n - 1):
        leaf = theta.detach().clone().requires_grad_()
        logits, _ = target.forward(leaf, ns, x[i:i + 1], train=False)
        g, = torch.autograd.grad(base.ce_loss(logits, y[i:i + 1]), leaf)
        want += g * g
    scale = float(want.max())
    rel = float(((got - want).abs() / (want.abs() + 1e-6 * scale)).max())
    check(scale > 0 and torch.allclose(got, want, rtol=2e-3, atol=1e-6 * scale),
          f"mini resnet Fisher: vmapped vs loop on the card: max rel err {rel}")
    print(f"phase 3b: la mini resnet {m['hw']}x{m['hw']} fp32, {n - 1} examples "
          f"and one padded: vmapped Fisher (microbatch 4 and a remainder) vs "
          f"the one-example loop on the card: max rel err {rel:.3g} (rtol "
          f"2e-3, atol 1e-6 of max {scale:.3g})", flush=True)


# ---- multi-chain runs ---------------------------------------------------------

# the JAX package's hardware smoke matrix (tools/tpu_smoke_all_methods.py:
# 24-49) at num_chains=2: the seven methods of SMOKE with its deviations,
# and SGLD, SGHMC, cSGLD and cSGHMC with the matrix's hparams and lr.
# method -> (hparams, lr, epochs)
CHAIN_SMOKE = {
    **SMOKE,
    "sgld": ("prior_sig=1.0,Ninflate=1.0,nd=0.05,burnin=0,thin=2,"
             "bias=informative,nst=2", 2e-2, 2),
    "sghmc": ("prior_sig=1.0,Ninflate=1.0,nd=0.05,burnin=0,thin=2,"
              "bias=informative,nst=2,momentum_decay=0.05", 2e-2, 2),
    "csgld": ("prior_sig=1.0,Ninflate=1.0,nd=0.01,thin=2,bias=informative,"
              "nst=2", 2e-2, 2),
    "csghmc": ("prior_sig=0.05,Ninflate=1.0,nd=0.01,thin=2,bias=informative,"
               "nst=2,momentum_decay=0.05", 2e-2, 2),
}
N_CHAINS = 2
# the kernel each chain's step launches; the other methods launch none
CHAIN_KERNEL = {"sgld": "sgld_update", "csgld": "sgld_update",
                "sghmc": "sghmc_update", "csghmc": "csghmc_update",
                "csghmc_fs": "csghmc_update", **METHOD_KERNEL}


def phase_chain_path(method):
    """One method at num_chains=2 on the full-width MLP through
    MultiChainRunner.train, every kernel's count set to 0 just before and
    read just after: C x steps launches of the method's kernel, none of the
    others; artifacts in a temporary directory, deleted after."""
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.ops import kernels
    from bayesdll_tpu_torch.parallel import MultiChainRunner

    hp, lr, epochs = CHAIN_SMOKE[method]
    cfg = Config(method=method, hparams=hp, dataset="synthetic",
                 backbone="mlp_mnist", epochs=epochs, batch_size=SMOKE_BATCH,
                 lr=lr, num_cycles=2, seed=0, device="cuda",
                 num_chains=N_CHAINS)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"{method}_chains_", dir=SCRATCH))
    try:
        runner, loaders = make_runner(cfg, workdir=str(work))
        check(runner.target.n_params == 2_797_010, "full-width mlp_mnist")
        mc = MultiChainRunner(runner, workdir=str(work))
        reset_launches()
        tic = time.perf_counter()
        res = mc.train(*loaders)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tic
        counts = read_launches()
        files = {p.relative_to(work).as_posix() for p in work.rglob("*")
                 if p.is_file()}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    what = f"{method} mlp_mnist {N_CHAINS} chains"
    steps = epochs * len(loaders[0])
    want = dict.fromkeys(kernels.launch_counts(), 0)
    if method in CHAIN_KERNEL:
        want[CHAIN_KERNEL[method]] = N_CHAINS * steps
    check(counts == want, f"{what}: launches {counts}, want {want}")
    thetas = mc.trainer.iterates()
    check(bool(torch.isfinite(thetas).all()), f"{what}: every chain's θ finite")
    gap = float((thetas[0] - thetas[1]).abs().max())
    check(gap > 1e-6, f"{what}: the chains' θ differ ({gap})")
    check(all(math.isfinite(x) for x in res["train_losses"]),
          f"{what}: finite losses")
    for key in ("nll", "ece", "mce"):
        check(key in res and math.isfinite(res[key]), f"{what}: result {key}")
    check(res["test_err"] < 0.5, f"{what}: chain-mixture test error "
          f"{res['test_err']} well below chance (0.9)")
    check({"chains_ckpt.pkl", "logits_test.pkl"} <= files,
          f"{what}: artifacts {sorted(files)}")
    extra = ""
    if mc.chain_cycle_stats:
        weights = mc.gmm_weights_per_chain()
        check(all(w and abs(sum(w.values()) - 1.0) < 1e-9 for w in weights),
              f"{what}: per-chain GMM weights sum to 1: {weights}")
        extra = "GMM weights " + weights_text(weights)
    if method == "csghmc_fs":
        snaps = sorted(mc.runner.full_samples)
        want_snaps = [(c, ep) for c in range(N_CHAINS) for ep in FS_SNAPSHOTS]
        check(snaps == want_snaps, f"{what}: snapshots {snaps}")
        check({f"full_samples_net_chain{c}_ep{ep}.pkl" for c, ep in snaps}
              <= files, f"{what}: snapshot files {sorted(files)}")
        bma = res["bma"]
        check(bma["test_ensemble_err"] < 0.5,
              f"{what}: BMA test error {bma['test_ensemble_err']}")
        extra += f"; snapshots {snaps}; BMA test error " \
                 f"{bma['test_ensemble_err']:.4f}"
    elif method == "la":
        sig2 = runner.prior_sig ** 2
        _, vars_ = mc._la_stage2
        check(bool(torch.isfinite(vars_).all()), f"{what}: vars finite")
        lo, hi = float(vars_.min()), float(vars_.max())
        check(0.0 < lo and hi <= sig2 + 1e-8,
              f"{what}: 0 < vars <= prior_sig^2 = {sig2}: [{lo}, {hi}]")
        extra = (f"vars in [{lo:.4g}, {hi:.4g}]; Fisher per chain "
                 f"{[round(t, 2) for t in res['fisher_time_per_chain']]} s")
    print(f"phase 3c: [{CARD}] {what} D={runner.target.dim} lr={lr} batch "
          f"{SMOKE_BATCH}, {epochs} epochs = {steps} steps per chain in "
          f"{secs:.2f} s incl. eval; launches {counts}; mean losses="
          f"{[round(x, 4) for x in res['train_losses']]}; nll={res['nll']:.4f} "
          f"ece={res['ece']:.4f} test_err={res['test_err']:.4f}; chains' θ "
          f"max gap {gap:.4g}; {extra}", flush=True)
    return counts, (mc, loaders)


def weights_text(weights) -> str:
    return "; ".join(f"chain {c}: " + ", ".join(
        f"cycle {k} {v:.4f}" for k, v in sorted(w.items()))
        for c, w in enumerate(weights))


class ChainBatches:
    """Chain c's batches for a single-chain runner: in the epoch of the
    runner's step counter, `chain_view(c, epoch)` of the train loader."""

    def __init__(self, loader, c, runner):
        self.loader, self.c, self.runner = loader, c, runner
        self.batch_size = loader.batch_size

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        return iter(self.loader.chain_view(
            self.c, self.runner.bi // len(self.loader)))


def phase_chain_reference(method, hp, fields, momentum=0.0):
    """Chain c of a 2-chain run on the card equals, bit for bit, the
    single-chain run on the card that starts from chain c's initial state,
    takes chain c's batches and has chain c's seed: width-32 MLP, fp32 with
    TF32 off, noise on, 4 epochs of 2 cycles."""
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.parallel import MultiChainRunner

    def config(seed=0):
        cfg = Config(method=method, hparams=dict(hp), dataset="synthetic",
                     backbone="mlp_mnist", epochs=4, batch_size=64, lr=1e-2,
                     momentum=momentum, num_cycles=2, seed=seed,
                     val_heldout=0.15, device="cuda")
        cfg.synthetic_n_train = 512
        cfg.synthetic_n_test = 256
        return cfg

    runner, loaders = make_runner(config(), width=32, depth=2)
    mc = MultiChainRunner(runner, N_CHAINS)
    start = [runner.iterate(s).clone() for s in mc.trainer.states]
    reset_launches()
    mc.train(*loaders)
    launched = sum(read_launches().values())
    for c, seed in enumerate(mc.trainer.seeds):
        single, sl = make_runner(config(), width=32, depth=2)
        single.cfg = dataclasses.replace(single.cfg, seed=seed)
        single.seed = seed
        single.state = single.init_state(start[c].clone())
        single.train(ChainBatches(sl[0], c, single), *sl[1:])
        for f in fields:
            a, b = getattr(single.state, f), getattr(mc.trainer.states[c], f)
            check(torch.equal(a, b), f"{method}: chain {c} vs its single-chain "
                  f"run, {f}: max abs diff {float((a - b).abs().max())}")
    check(launched == N_CHAINS * mc.trainer.bi,
          f"{method}: {launched} launches in {mc.trainer.bi} steps")
    a, b = (s.theta for s in mc.trainer.states)
    print(f"phase 3b: {method} width-32 MLP fp32, {N_CHAINS} chains x "
          f"{mc.trainer.bi} steps with noise on the card: each chain bitwise "
          f"equal ({', '.join(fields)}) to the single-chain run from its "
          f"initial θ, batches and seed; chains' θ max gap "
          f"{float((a - b).abs().max()):.4g}", flush=True)


def stacked_batches(loader, steps: int):
    """The loader's first `steps` batches on the card, [K, B, ...] (repeated
    where the loader has fewer)."""
    xs, ys = [], []
    for x, y, _ in loader:
        xs.append(x)
        ys.append(y)
    xs = [xs[i % len(xs)] for i in range(steps)]
    ys = [ys[i % len(ys)] for i in range(steps)]
    return (torch.from_numpy(np.stack(xs)).cuda(),
            torch.from_numpy(np.stack(ys)).cuda())


# tools/tpu_smoke_all_methods.py:52-71 (BIG_CONFIGS), through the port's
# CLI on synthetic data (10 classes, 461 training images)
BIG_CONFIGS = {
    "csghmc_multichain_gmm": [
        "--method", "csghmc", "--backbone", "resnet50",
        "--num_chains", "2", "--epochs", "2", "--num_cycles", "1",
        "--batch_size", "32", "--lr", "2e-2",
        "--compute_dtype", "bfloat16",
        "--hparams", "prior_sig=1.0,Ninflate=1.0,nd=0.01,thin=2,"
                     "bias=informative,nst=2,momentum_decay=0.05",
    ],
    "la_multichain_fisher": [
        "--method", "la", "--backbone", "resnet50",
        "--num_chains", "2", "--epochs", "1",
        "--batch_size", "32", "--lr", "2e-2",
        "--compute_dtype", "bfloat16",
        "--hparams", "prior_sig=0.1,Ninflate=1.0,bias=informative,nst=2,"
                     "fisher_microbatch=8",
    ],
}
# BIGSMOKE_r05.json: the JAX package's two runs on a TPU v5e (white-noise
# classes, so the numbers compare in kind only)
BIGSMOKE = {"csghmc_multichain_gmm": (3.3885, 0.8984),
            "la_multichain_fisher": (1.4567e17, 0.918)}


def bn_differs(a, b) -> bool:
    return any(not torch.equal(x, y) for x, y in zip(
        tree_leaves(a["batch_stats"]), tree_leaves(b["batch_stats"])))


@contextlib.contextmanager
def watched_multichain(seen: dict):
    """MultiChainRunner.train with its instance kept in seen["mc"], the
    chains' likelihood passes and stage 2 timed, and stage 2 checked to
    leave every batch_stats it reads or holds as it was."""
    from bayesdll_tpu_torch.parallel.runner import MultiChainRunner
    train = MultiChainRunner.train

    def watched(self, *args, **kw):
        seen["mc"] = self
        likelihoods, laplace = self._chain_likelihoods, self._chain_laplace

        def timed_likelihoods(*args):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            out = likelihoods(*args)
            torch.cuda.synchronize()
            seen.setdefault("lik_secs", []).append(time.perf_counter() - tic)
            return out

        def checked_laplace(loader):
            held = [self.trainer.net_states] + (
                [self._la_best[2]] if self._la_best is not None else [])
            before = [[tree_clone(ns) for ns in h] for h in held]
            out = laplace(loader)
            seen["stats_same"] = all(
                not bn_differs(a, b) for h, b0 in zip(held, before)
                for a, b in zip(h, b0))
            return out
        self._chain_likelihoods = timed_likelihoods
        self._chain_laplace = checked_laplace
        return train(self, *args, **kw)
    MultiChainRunner.train = watched
    try:
        yield seen
    finally:
        MultiChainRunner.train = train


def entry_main(main, argv):
    """An entry point's main with its log kept off this script's output
    (printed in its last 6,000 characters if the run fails); returns the
    results and the log.  The log handlers it adds are removed after."""
    import io
    import logging
    logger = logging.getLogger("bayesdll_tpu_torch")
    handlers = list(logger.handlers)
    log = io.StringIO()
    try:
        with contextlib.redirect_stdout(log):
            return main(argv), log.getvalue()
    except BaseException:
        print(log.getvalue()[-6000:], flush=True)
        raise
    finally:
        for h in logger.handlers[len(handlers):]:
            logger.removeHandler(h)
            h.close()


def cli_main(argv):
    """The port's CLI main (cli/demo.py), as `entry_main` runs it."""
    from bayesdll_tpu_torch.cli import demo
    return entry_main(demo.main, argv)[0]


def phase_big_chains(smi, name):
    """One of the JAX package's two big multi-chain smokes through the
    port's CLI on the card, every kernel's count set to 0 just before and
    read just after, its log directory deleted after."""
    from bayesdll_tpu_torch.ops import kernels
    argv = BIG_CONFIGS[name]
    SCRATCH.mkdir(parents=True, exist_ok=True)
    logdir = tempfile.mkdtemp(prefix=f"{name}_", dir=SCRATCH)
    seen = {}
    try:
        with watched_multichain(seen):
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            tic = time.perf_counter()
            res = cli_main(argv + ["--dataset", "synthetic", "--device", "cuda",
                                   "--log_dir", logdir])
            torch.cuda.synchronize()
            secs = time.perf_counter() - tic
            counts = read_launches()
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    mc = seen["mc"]
    tr = mc.trainer
    steps = tr.bi
    check(mc.runner.target.n_params == RESNET50_PARAMS, f"{name}: resnet50")
    want = dict.fromkeys(kernels.launch_counts(), 0)
    if mc.runner.method_name == "csghmc":
        want["csghmc_update"] = N_CHAINS * steps
    check(counts == want, f"{name}: launches {counts}, want {want}")
    thetas = tr.iterates()
    check(bool(torch.isfinite(thetas).all()), f"{name}: every θ finite")
    check(not torch.equal(thetas[0], thetas[1]), f"{name}: the chains differ")
    check(bn_differs(tr.net_states[0], tr.net_states[1]),
          f"{name}: the chains' batch_stats differ after training")
    for key in ("nll", "test_err"):
        check(key in res and math.isfinite(res[key]), f"{name}: {key}")
    extra = ""
    if "stats_same" in seen:
        check(seen["stats_same"], f"{name}: stage 2 left batch_stats as "
              "they were")
        _, vars_ = mc._la_stage2
        check(bool(torch.isfinite(vars_).all()) and float(vars_.min()) > 0,
              f"{name}: variances finite and positive")
        fisher = res["fisher_time_per_chain"]
        n = mc._train_loader.num_examples
        extra = (f"stage 2 left batch_stats untouched; Fisher per chain "
                 f"{[round(t, 2) for t in fisher]} s over {n} examples = "
                 f"{[round(n / t, 1) for t in fisher]} examples/s; vars in "
                 f"[{float(vars_.min()):.4g}, {float(vars_.max()):.4g}]")
    if seen.get("lik_secs"):
        extra = (f"GMM likelihood pass (2 chains, nst=2, "
                 f"{mc._train_loader.num_examples} images) "
                 f"{[round(t, 2) for t in seen['lik_secs']]} s; GMM weights "
                 f"{weights_text(mc.gmm_weights_per_chain())}")
    jax_nll, jax_err = BIGSMOKE[name]
    print(f"phase 3c: [{smi}] {name} (port CLI) resnet50 bf16 batch 32, "
          f"{N_CHAINS} chains x {steps} steps, {secs:.2f} s in all, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"launches {counts}; nll={res['nll']:.6g} test_err="
          f"{res['test_err']:.4f} (BIGSMOKE_r05.json, JAX on a TPU v5e: nll "
          f"{jax_nll:.6g}, err {jax_err}; white-noise classes, chance 0.9); "
          f"{extra}", flush=True)
    return mc, counts


# ---- phase 6: the fused path (fused_steps) ---------------------------------

# the eleven methods the fused path serves; the kernel each one's step
# launches
FUSED_KERNEL = {"csghmc": "csghmc_update", "sgld": "sgld_update",
                "sghmc": "sghmc_update", "csgld": "sgld_update",
                "csghmc_fs": "csghmc_update", "vanilla": None, "la": None,
                **METHOD_KERNEL}
FUSED_K = 10  # the replayed segment the profiler traces
# (seed, step, gate) at which the kernels, reading them from their row, are
# held to their plain versions: a seed past 2^63 and a step past 2^32
# included
DEV_POINTS = ((7, 11, True), (2**63 + 12345, 2**33 + 5, True),
              (123456789, 1, False), (0, 0, True))


def state_tensors(state) -> dict:
    """Every tensor of a sampler state, its moments' included, by name."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": t
                        for k, t in state_tensors(v).items()})
    return out


def host_counts(state):
    """(step, Adam's t, moments count) of a state, the host's bookkeeping;
    None where the state has none."""
    m = getattr(state, "moments", None)
    return (state.step, getattr(state, "t", None), None if m is None
            else getattr(m, "cnt", getattr(m, "n", None)))


def differing(a, b) -> dict:
    """The state tensors that are not bitwise equal, with their max abs
    difference; host counts that differ under "counts"."""
    ta, tb = state_tensors(a), state_tensors(b)
    out = {k: float((ta[k] - tb[k]).abs().max()) for k in ta
           if not torch.equal(ta[k], tb[k])}
    if host_counts(a) != host_counts(b):
        out["counts"] = (host_counts(a), host_counts(b))
    return out


def phase_fused_path(method, ref, ref_loaders):
    """(a) One of the eleven through `train` with fused_steps on the
    full-width MLP, in the config of its per-step path `ref` (the trained
    runner): the state (θ, v or buf, the moments), the host counts and the
    per-epoch losses bitwise equal to the per-step run's, noise on; the
    method's kernel launched once per step (a replay counts its graph's
    launches), no other; test error below 0.5."""
    from bayesdll_tpu_torch.ops import kernels
    cfg = dataclasses.replace(ref.cfg, fused_steps=True)
    runner, loaders = make_runner(cfg, loaders=ref_loaders)
    reset_launches()
    tic = time.perf_counter()
    res = runner.train(*loaders)
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    counts = read_launches()
    steps = cfg.epochs * len(loaders[0])
    want = dict.fromkeys(kernels.launch_counts(), 0)
    if FUSED_KERNEL[method]:
        want[FUSED_KERNEL[method]] = steps
    check(counts == want, f"{method} fused: launches {counts}, want {want}")
    diff = differing(ref.state, runner.state)
    check(not diff, f"{method} fused vs per step: differ in {diff}")
    check(res["train_losses"] == ref.results["train_losses"],
          f"{method} fused vs per step: losses {res['train_losses']} vs "
          f"{ref.results['train_losses']}")
    check(res["test_err"] < 0.5, f"{method} fused: test error "
          f"{res['test_err']} well below chance (0.9)")
    graph = runner._step_graphs[runner.seed]
    check(graph.graphs, f"{method} fused: a captured graph")
    print(f"phase 6a: [{CARD}] {method} mlp_mnist fused_steps, batch "
          f"{cfg.batch_size}, {steps} steps in {secs:.2f} s incl. eval and "
          f"capture (eager steps and captures {graph.capture_s:.3f} s); "
          f"launches "
          f"{counts}; graphs for collect flags {sorted(graph.graphs)}; state "
          f"({', '.join(state_tensors(runner.state))}), "
          f"counts {host_counts(runner.state)} and losses bitwise equal to "
          f"the per-step run, noise on; test_err={res['test_err']:.4f}",
          flush=True)
    return runner, loaders


def phase_fused_trace(smi, method, runner, loaders):
    """(e) torch.profiler over one replayed segment of FUSED_K steps of a
    runner whose graph exists: on the host one cudaGraphLaunch per step and
    no matrix product or index select dispatched; on the card the method's
    kernel FUSED_K times."""
    from torch.profiler import ProfilerActivity, profile
    kernel = FUSED_KERNEL[method]
    xs, ys = stacked_batches(loaders[0], FUSED_K)
    ep = runner.cfg.epochs - 1
    runner.run_steps(ep, xs, ys, runner.bi)  # the graph of these addresses
    torch.cuda.synchronize()
    key = runner._step_graphs[runner.seed].key
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.run_steps(ep, xs, ys, runner.bi)
        torch.cuda.synchronize()
    check(runner._step_graphs[runner.seed].key == key,
          f"{method}: the traced segment replayed, no capture")
    n = {"kernel": 0, "graph": 0, "launch": 0, "dispatch": 0}
    for e in prof.key_averages():
        on_card = e.device_type == torch.autograd.DeviceType.CUDA
        if on_card and f"{kernel}_kernel" in e.key:
            n["kernel"] += e.count
        elif not on_card and e.key == "cudaGraphLaunch":
            n["graph"] += e.count
        elif not on_card and e.key == "cudaLaunchKernel":
            n["launch"] += e.count
        elif not on_card and e.key in ("aten::addmm", "aten::mm",
                                       "aten::index_select"):
            n["dispatch"] += e.count
    check(n["kernel"] == FUSED_K and n["graph"] == FUSED_K
          and n["dispatch"] == 0,
          f"{method}: a replayed segment of {FUSED_K} steps traced {n}")
    print(f"phase 6e: [{smi}] {method} mlp_mnist, one replayed segment of "
          f"{FUSED_K} steps under torch.profiler: {kernel} on the card "
          f"{n['kernel']} times, cudaGraphLaunch {n['graph']} times, "
          f"aten::addmm/mm/index_select dispatched {n['dispatch']} times, "
          f"cudaLaunchKernel {n['launch']} times (the segment's copies in "
          "and out)", flush=True)


def phase_fused_chain_path(method, ref, ref_loaders):
    """(c) One of the eleven at num_chains=2 with fused_steps on the
    full-width MLP, in the config of its per-step 2-chain path `ref` (the
    trained MultiChainRunner): each chain's state and host counts bitwise
    equal to the per-step run's; the kernel launched C x steps; the
    chain-mixture test error below 0.5."""
    from bayesdll_tpu_torch.ops import kernels
    from bayesdll_tpu_torch.parallel import MultiChainRunner
    cfg = dataclasses.replace(ref.cfg, fused_steps=True)
    runner, loaders = make_runner(cfg, loaders=ref_loaders)
    mc = MultiChainRunner(runner)
    reset_launches()
    tic = time.perf_counter()
    res = mc.train(*loaders)
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    counts = read_launches()
    what = f"{method} mlp_mnist {N_CHAINS} chains fused"
    steps = cfg.epochs * len(loaders[0])
    want = dict.fromkeys(kernels.launch_counts(), 0)
    if FUSED_KERNEL[method]:
        want[FUSED_KERNEL[method]] = N_CHAINS * steps
    check(counts == want, f"{what}: launches {counts}, want {want}")
    for c in range(N_CHAINS):
        diff = differing(ref.trainer.states[c], mc.trainer.states[c])
        check(not diff, f"{what}: chain {c} differs from the per-step run "
              f"in {diff}")
    check(res["train_losses"] == ref.results["train_losses"],
          f"{what}: losses differ from the per-step run")
    check(res["test_err"] < 0.5, f"{what}: chain-mixture test error "
          f"{res['test_err']} well below chance (0.9)")
    check(sorted(runner._step_graphs) == sorted(mc.trainer.seeds),
          f"{what}: one graph per chain")
    print(f"phase 6c: [{CARD}] {what}, batch {cfg.batch_size}, {steps} steps "
          f"per chain in {secs:.2f} s incl. eval and capture; launches "
          f"{counts}; each chain's state and counts bitwise equal to the "
          f"per-step 2-chain run, noise on; one graph per chain; "
          f"test_err={res['test_err']:.4f}", flush=True)


def phase_kernels_at_dev_points(smi, target, label):
    """(e) Each update kernel at `target`'s D, noise on, at each (seed, step,
    gate) of DEV_POINTS read from its row, against its plain version handed
    the kernel's normals (`philox_draw_plain` of the kernel's stream in the
    kernel's fp32 arithmetic, as phase 6e holds philox_draw to it) on the
    windows of `draw_windows`: within TOL, as phase 2 holds the kernels,
    and csghmc bitwise where its gate is 0.  Returns the max abs error of
    each."""
    from bayesdll_tpu_torch.ops import fused
    n_eff = 1000.0
    operands = {"csghmc_update": csghmc_inputs(target),
                **{n: sg_operands(n, *sg_inputs(target)) for n in SG_ALPHA}}
    errs = {}
    for name, args in operands.items():
        err = 0.0
        for seed, step, gate in DEV_POINTS:
            if name == "csghmc_update":
                got = csghmc_kernel(args, nd=1.0, gate=gate, n_eff=n_eff,
                                    seed=seed, step=step)
            else:
                got = sg_kernel(name, args, nd=1.0, n_eff=n_eff, seed=seed,
                                step=step)
            for lo, hi in draw_windows(target.dim):
                z = fused.philox_draw_plain(
                    hi - lo, kind="normal", stream=KERNEL_STREAM[name],
                    seed=seed, step=step, device="cuda", offset=lo,
                    fp32=True)
                part = [t[lo:hi] for t in args]
                if name == "csghmc_update":
                    want = fused.csghmc_update(
                        *part[:3], prior_sig=1.0, n_eff=n_eff, nd=1.0,
                        alpha=0.05, lr=part[3], should_sample=gate, noise=z)
                else:
                    want = sg_plain(name, part, nd=1.0, n_eff=n_eff, noise=z)
                pairs = [(x[lo:hi], y) for x, y in zip(got, want)]
                e = max(float((x - y).abs().max()) for x, y in pairs)
                err = max(err, e)
                exact = name == "csghmc_update" and not gate
                check(all(torch.equal(x, y) if exact else
                          torch.allclose(x, y, **TOL) for x, y in pairs),
                      f"{name} vs plain with its normals at D={target.dim} "
                      f"[{lo}, {hi}), (seed, step, gate) = "
                      f"{(seed, step, gate)}: max abs err {e}")
            del got
        errs[name] = err
        print(f"phase 6e: [{smi}] {name} at D={target.dim} ({label}), "
              f"(seed, step, gate) from its row at each of {DEV_POINTS}: "
              f"vs plain with the kernel's normals max abs err {err:.3g} "
              f"(rtol=atol=1e-6"
              + ("; bitwise at gate 0)" if name == "csghmc_update" else ")"),
              flush=True)
    del operands, args
    free_device()
    errs["adam_sghmc_update"] = phase_adam_at_dev_points(smi, target, label)
    return errs


def phase_adam_at_dev_points(smi, target, label):
    """(e) The Adam pass at `target`'s D in both ADAM_FORMS, noise on, at
    each (seed, step) of DEV_POINTS read from its row, against the eager
    composition it replaces handed the kernel's normals (philox_draw_plain
    of the Adam stream in the kernel's fp32 arithmetic) on the windows of
    `draw_windows`: bitwise where the normals are (the pass rounds as the
    eager kernels do), within TOL.  Returns the max abs error."""
    from bayesdll_tpu_torch.ops import fused, kernels
    n_eff = 1000.0
    args = adam_inputs(target)
    err, same, of = 0.0, 0, 0
    for form in ADAM_FORMS:
        for seed, step, gate in DEV_POINTS:
            got = adam_kernel(args, form, nd=1.0, n_eff=n_eff,
                              dev=kernels.dev_scalars(seed, step, gate))
            for lo, hi in draw_windows(target.dim):
                z = fused.philox_draw_plain(
                    hi - lo, kind="normal", stream=kernels.STREAM_ADAM,
                    seed=seed, step=step, device="cuda", offset=lo,
                    fp32=True)
                want = adam_plain([t[lo:hi] for t in args], form, nd=1.0,
                                  n_eff=n_eff, noise=z)
                pairs = [(x[lo:hi], y) for x, y in zip(got, want)]
                e = max(float((x - y).abs().max()) for x, y in pairs)
                err = max(err, e)
                same += sum(int(torch.equal(x, y)) for x, y in pairs)
                of += len(pairs)
                check(all(torch.allclose(x, y, **TOL) for x, y in pairs),
                      f"adam_sghmc_update ({form}) vs the eager composition "
                      f"with its normals at D={target.dim} [{lo}, {hi}), "
                      f"(seed, step) = {(seed, step)}: max abs err {e}")
            del got
    del args
    free_device()
    print(f"phase 6e: [{smi}] adam_sghmc_update at D={target.dim} ({label}), "
          f"forms {list(ADAM_FORMS)}, (seed, step) from its row at each of "
          f"{DEV_POINTS}: vs the eager composition with the kernel's normals "
          f"max abs err {err:.3g} (rtol=atol=1e-6); {same} of {of} "
          f"(vector, window) pairs bitwise", flush=True)
    return err


def phase_fused_vit(vit, loaders):
    """(d) ViT-L/32 cSGHMC at full width with fused_steps (the path's
    config, at its depth; K = 3 under the 256 MiB window): through `train`, no
    checkpoints; training and test error below 0.5; the kernel launched
    once per step.  Its per-epoch losses against the spread of two
    per-step runs (the path's, and one more here without checkpoints):
    attention's backward need not be deterministic, so the gate is that
    the fused run lies no farther from the first per-step run than twice
    the largest gap between the two per-step runs, plus 1e-6 of the loss."""
    ref = vit.results["train_losses"]
    second, sl = make_runner(vit.cfg, loaders=loaders)
    tic = time.perf_counter()
    res2 = second.train(*sl)
    secs2 = time.perf_counter() - tic
    del second
    free_device()
    runner, fl = make_runner(dataclasses.replace(vit.cfg, fused_steps=True),
                             loaders=loaders)
    reset_launches()
    tic = time.perf_counter()
    res = runner.train(*fl)
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    counts = read_launches()
    steps = runner.cfg.epochs * len(fl[0])
    losses, errs = res["train_losses"], res["train_errors"]
    spread = max(abs(a - b) for a, b in zip(ref, res2["train_losses"]))
    gap = max(abs(a - b) for a, b in zip(ref, losses))
    print(f"phase 6d: [{CARD}] csghmc vit_l_32 fused_steps bf16 batch "
          f"{runner.cfg.batch_size}, {steps} steps in {secs:.2f} s incl. "
          f"eval and capture (a second per-step run {secs2:.2f} s); launches "
          f"{counts}; last epoch loss {losses[-1]:.4f} error {errs[-1]:.4f}; "
          f"test_err={res['test_err']:.4f} nll={res['nll']:.4f}; per-epoch "
          f"losses: fused vs per-step run 1 max gap {gap:.3g}, per-step runs "
          f"1 vs 2 (the spread) {spread:.3g}", flush=True)
    want = {k: 0 for k in counts}
    want["csghmc_update"] = steps
    check(counts == want, f"vit_l_32 fused: launches {counts}, want {want}")
    check(errs[-1] < VIT_ERR and res["test_err"] < VIT_ERR,
          f"vit_l_32 fused: training error {errs[-1]}, test error "
          f"{res['test_err']} below {VIT_ERR}")
    check(gap <= 2 * spread + 1e-6 * max(abs(x) for x in ref),
          f"vit_l_32 fused: per-epoch losses {gap} from the per-step run's, "
          f"spread of two per-step runs {spread}")
    del runner
    free_device()


# ---- philox_draw: the drawing methods' whole-vector draw ---------------------

# the draws it replaces: jax.random calls inside the JAX package's scanned
# step, with the key folded from the step (no Pallas kernel)
DRAW_REPLACES = ("bayesdll_tpu/methods/vi.py:78 (jax.random.normal); "
                 "bayesdll_tpu/methods/mc_dropout.py:61,85 "
                 "(jax.random.uniform); bayesdll_tpu/ops/fused.py:118 and "
                 "bayesdll_tpu/methods/adam_csghmc.py:119 (jax.random.normal)")
# the work of one draw per element: its fp32 output written once, nothing
# read; the integer instructions no schedule avoids, 10 Philox rounds of
# 2 wide multiplies (each gives the high and the low word) and 2
# three-input xors for 4 elements (the key schedule is the same for every
# thread, and the Box-Muller of normals is fp32 work on other pipes: both
# left out of the bound).  Counting 25 (the multiplies' halves, the xors
# in pairs, the key additions) gave a bound the uniform draw ran under.
DRAW_BYTES_PER_ELEM = 4
DRAW_INT_OPS_PER_ELEM = 10
# 32-bit integer adds, xors and multiplies: 64 results per SM and clock on
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), a quarter of FP32_PEAK's 128 fused multiply-adds of 2 flops
INT32_PEAK = FP32_PEAK / 4
# normals against the plain version: the kernel's fp32 Box-Muller
# (normal_from_bits.cuh) against float64 Box-Muller of the same 24-bit
# uniforms, |z| at most 5.7; uniforms bitwise
DRAW_TOL = 1e-5
# the plain version runs on windows of this many elements at each end of a
# vector longer than two windows
DRAW_WINDOW = 1 << 22


def draw_windows(dim: int):
    """The element ranges of a [dim] draw held to the plain version."""
    if dim <= 2 * DRAW_WINDOW:
        return [(0, dim)]
    tail = (dim - DRAW_WINDOW) // 4 * 4
    return [(0, DRAW_WINDOW), (tail, dim)]


def ulp_diffs(a: torch.Tensor, b: torch.Tensor):
    """(elements that differ, the largest difference in ulps) of two fp32
    tensors of values of one sign, compared as integers."""
    d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
    return int((d != 0).sum()), int(d.max()) if d.numel() else 0


def phase_draw_kernel(smi, dim: int, label: str, flush):
    """(e) philox_draw at D = dim, (seed, step) read from its row at each
    of DEV_POINTS, for each draw: against its plain version (uniforms
    bitwise, normals within DRAW_TOL of float64 Box-Muller, and against the
    kernel's own fp32 arithmetic run in torch ops,
    `philox_draw_plain(fp32=True)`: bitwise, or within an ulp where
    MUFU.RSQ rounds r otherwise, the differing elements counted); the
    moments (normal mean within 0.01 and std within 2% of 1; uniforms in
    [0, 1) with mean within 0.01 of 0.5); the VI and Adam draws at one
    (seed, step) uncorrelated (|r| < 0.01).  Then its times with L2
    flushed before each launch, twice in turns: normal and uniform, the
    plain version, and torch.randn(D, generator=g) and torch.rand(D,
    generator=g) on the card (the same distributions, other bits) as the
    library calls; the normal draw's ratio to the uniform one and its share
    of the bound.  Returns the kernel's record."""
    from bayesdll_tpu_torch.ops import fused, kernels
    streams = {"vi": (kernels.STREAM_VI, "normal"),
               "adam": (kernels.STREAM_ADAM, "normal"),
               "mc_dropout": (kernels.STREAM_MC_DROPOUT, "uniform")}
    like = torch.empty(dim, device="cuda")
    err = 0.0
    emu_diff, emu_elems, emu_ulp = 0, 0, 0
    for seed, step, gate in DEV_POINTS:
        dev = kernels.dev_scalars(seed, step, gate)
        for name, (sid, kind) in streams.items():
            a = kernels.philox_draw(like, dev, kind=kind, stream=sid)
            for lo, hi in draw_windows(dim):
                kw = dict(kind=kind, stream=sid, seed=seed, step=step,
                          device="cuda", offset=lo)
                want = fused.philox_draw_plain(hi - lo, **kw)
                e = float((a[lo:hi] - want).abs().max())
                err = max(err, e)
                check(torch.equal(a[lo:hi], want) if kind == "uniform"
                      else e <= DRAW_TOL,
                      f"philox_draw {name} vs plain at D={dim} [{lo}, {hi}), "
                      f"(seed, step) = {(seed, step)}: max abs err {e}")
                if kind == "normal":
                    want = fused.philox_draw_plain(hi - lo, fp32=True, **kw)
                    n_diff, ulps = ulp_diffs(a[lo:hi], want)
                    emu_diff, emu_elems = emu_diff + n_diff, emu_elems + hi - lo
                    emu_ulp = max(emu_ulp, ulps)
                    check(ulps <= 1, f"philox_draw {name} vs its fp32 "
                          f"arithmetic at D={dim} [{lo}, {hi}), (seed, step) "
                          f"= {(seed, step)}: {n_diff} differ, by up to "
                          f"{ulps} ulps")
            del a, want
    dev = kernels.dev_scalars(*DEV_POINTS[1])
    z = {n: kernels.philox_draw(like, dev, kind=k, stream=sid)
         for n, (sid, k) in streams.items()}
    mean = float(torch.mean(z["vi"], dtype=torch.float64))
    std = float(torch.sqrt(torch.mean(
        (z["vi"].double() - mean) ** 2)))
    u = z["mc_dropout"]
    u_mean = float(torch.mean(u, dtype=torch.float64))
    u_lo, u_hi = float(u.min()), float(u.max())
    r = float(torch.mean((z["vi"].double() - mean) * (
        z["adam"].double() - float(torch.mean(z["adam"], dtype=torch.float64)))
    ) / (std * float(torch.std(z["adam"].double()))))
    check(abs(mean) < 0.01 and abs(std - 1.0) < 0.02,
          f"philox_draw normal at D={dim}: mean {mean}, std {std}")
    check(0.0 <= u_lo and u_hi < 1.0 and abs(u_mean - 0.5) < 0.01,
          f"philox_draw uniform at D={dim}: in [{u_lo}, {u_hi}], mean "
          f"{u_mean}")
    check(abs(r) < 0.01, f"philox_draw VI vs Adam stream at D={dim}: "
          f"correlation {r}")
    del z, u
    free_device()

    sid_vi = kernels.STREAM_VI
    row = kernels.dev_scalars(0, 1)

    def draw(kind="normal"):
        kernels.philox_draw(like, row, kind=kind, stream=sid_vi)

    gen = torch.Generator(device="cuda").manual_seed(0)
    timed = {
        "normal": draw,
        "randn": lambda: torch.randn(dim, generator=gen, device="cuda"),
        "uniform": lambda: draw("uniform"),
        "rand": lambda: torch.rand(dim, generator=gen, device="cuda"),
    }
    p1 = cuda_ms_cold(lambda: fused.philox_draw_plain(
        dim, kind="normal", stream=sid_vi, seed=0, step=1, device="cuda"), 3,
        flush, warmup=1)
    runs = {k: [] for k in timed}
    for order in (list(timed), list(timed)[::-1]):
        for k in order:
            runs[k].append(cuda_ms_cold(timed[k], 100, flush))
    p2 = cuda_ms_cold(lambda: fused.philox_draw_plain(
        dim, kind="normal", stream=sid_vi, seed=0, step=1, device="cuda"), 3,
        flush, warmup=1)
    k_warm = cuda_ms(draw, 100)
    ms = {k: sum(v) / len(v) for k, v in runs.items()}
    name = torch.cuda.get_device_name(0)
    bytes_ms = DRAW_BYTES_PER_ELEM * dim / peak_bytes_per_s(name) * 1e3
    ops_ms = DRAW_INT_OPS_PER_ELEM * dim / INT32_PEAK * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    plain_ms = (p1 + p2) / 2
    both = {k: "/".join(f"{t * 1e3:.2f}" for t in v) for k, v in runs.items()}
    print(f"phase 6e: [{smi}] philox_draw D={dim} ({label}), (seed, step) "
          f"from its row at each of {DEV_POINTS}, the VI, Adam and "
          f"MC-dropout draws vs plain: uniforms bitwise, normals max abs "
          f"err {err:.3g} (tol {DRAW_TOL}); "
          f"normals vs the kernel's fp32 arithmetic: {emu_diff} of "
          f"{emu_elems} differ, by at most {emu_ulp} ulp; "
          f"normal mean {mean:+.2e} std {std:.5f}, uniform in [{u_lo:.3g}, "
          f"{u_hi:.8f}] mean {u_mean:.5f}, VI vs Adam r {r:+.2e}; L2 flushed "
          f"before each launch (two runs in turns): normal {both['normal']} "
          f"us, uniform {both['uniform']} us, torch.randn {both['randn']} "
          f"us, torch.rand {both['rand']} us; normal {k_warm * 1e3:.2f} us "
          f"back to back; "
          f"normal / uniform {ms['normal'] / ms['uniform']:.3f}, normal / "
          f"torch.randn {ms['normal'] / ms['randn']:.3f}, uniform / "
          f"torch.rand {ms['uniform'] / ms['rand']:.3f}; bound "
          f"{bound_ms * 1e3:.2f} us ({bound_by}: "
          f"{DRAW_BYTES_PER_ELEM * dim / 1e6:.1f} MB written "
          f"{bytes_ms * 1e3:.2f} us, {DRAW_INT_OPS_PER_ELEM} integer ops per "
          f"element at {INT32_PEAK / 1e12:.2f} TOP/s {ops_ms * 1e3:.2f} us) = "
          f"{bound_ms / ms['normal']:.1%} of roofline for normals, "
          f"{bound_ms / ms['uniform']:.1%} for uniforms; plain version "
          f"{plain_ms * 1e3:.1f} us ({p1 * 1e3:.1f}/{p2 * 1e3:.1f})",
          flush=True)
    del like
    free_device()
    return dict(ms=ms["normal"], plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=ms["randn"], max_abs_err=err,
                uniform_ms=ms["uniform"], uniform_library_ms=ms["rand"],
                normal_to_uniform=ms["normal"] / ms["uniform"],
                normal_share_of_bound=bound_ms / ms["normal"],
                fp32_arithmetic={"differing": emu_diff, "of": emu_elems,
                                 "max_ulps": emu_ulp},
                runs_ms=runs, dim=dim)


def phase_fused_vit_adam(smi, vit, xs, ys):
    """(d) ViT-L/32 Adam-cSGHMC at full width, bf16, batch 128, the smoke
    matrix's Adam hparams on the cSGHMC run's target, config and batches,
    fused in segments of K = 3 (as the 256 MiB window cuts phase 6d's
    run): from the same θ, two per-step runs of VIT_STEPS steps
    (step_loop) and one fused (run_steps), their per-step losses held as
    6d holds cSGHMC's (the fused run no farther from the first per-step
    run than twice the spread of the two, plus 1e-6 of the loss);
    adam_sghmc_update launched once per step and no other kernel.  Returns the
    fused run's launches."""
    from bayesdll_tpu_torch.config import parse_hparams
    from bayesdll_tpu_torch.methods import get_runner_cls

    hp = {**vit.cfg.hparams, **parse_hparams(SMOKE["adam_csghmc"][0]),
          "perform_cold_restarts": "0"}
    cfg = dataclasses.replace(vit.cfg, method="adam_csghmc", hparams=hp)
    xs = torch.stack([xs[i % len(xs)] for i in range(VIT_STEPS)])
    ys = torch.stack([ys[i % len(ys)] for i in range(VIT_STEPS)])
    ep, k = cfg.epochs - 1, 3

    def fresh():
        r = get_runner_cls("adam_csghmc")(vit.target, vit.state.theta,
                                          vit.net_state, cfg)
        r.sched = vit.sched
        return r

    losses, thetas = [], []  # the per-step runs' θ on the host
    for _ in range(2):
        r = fresh()
        loss, _ = r.step_loop(ep, xs, ys, 0)
        losses.append(loss.double().cpu())
        thetas.append(r.state.theta.cpu())
        del r
        free_device()
    runner = fresh()
    reset_launches()
    fused_loss = torch.cat([runner.run_steps(ep, xs[s:s + k], ys[s:s + k], s)[0]
                            for s in range(0, VIT_STEPS, k)])
    torch.cuda.synchronize()
    counts = read_launches()
    fused_loss = fused_loss.double().cpu()
    want = {n: 0 for n in counts}
    want["adam_sghmc_update"] = VIT_STEPS
    check(counts == want, f"adam_csghmc vit_l_32 fused: launches {counts}, "
          f"want {want}")
    check(runner.state.t == VIT_STEPS and runner.state.step == VIT_STEPS,
          f"adam_csghmc vit_l_32 fused: t {runner.state.t}, step "
          f"{runner.state.step}")
    spread = float((losses[0] - losses[1]).abs().max())
    gap = float((losses[0] - fused_loss).abs().max())
    scale = float(losses[0].abs().max())
    th_spread = float((thetas[0] - thetas[1]).abs().max())
    th_gap = float((thetas[0] - runner.state.theta.cpu()).abs().max())
    del thetas
    check(bool(torch.isfinite(fused_loss).all())
          and gap <= 2 * spread + 1e-6 * scale,
          f"adam_csghmc vit_l_32 fused: per-step losses {gap} from the "
          f"per-step run's, spread of two per-step runs {spread}")
    print(f"phase 6d: [{smi}] adam_csghmc vit_l_32 bf16 batch "
          f"{cfg.batch_size}, fused in segments of {k}: launches {counts}; "
          f"per-step losses fused vs per-step run 1 max gap {gap:.3g}, "
          f"per-step runs 1 vs 2 (the spread) {spread:.3g}; theta max gap "
          f"{th_gap:.3g} (spread {th_spread:.3g}); t {runner.state.t} after "
          f"{VIT_STEPS} steps", flush=True)
    del runner
    free_device()
    return counts


# ---- phase 7: real data -------------------------------------------------------

# the JAX pre-training driver's cell (bayesdll_tpu/cli/pretrain.py): cSGHMC
# on ResNet-101 from scratch, CIFAR-100 (50,000 + 10,000 images of 32x32x3),
# batch 256, lr 0.1, momentum 0.9, the reference's hparams, all at the
# CLI's defaults but the length: 1 epoch in 1 cycle, whose second half
# collects samples (every 10th step) and whose end runs the test evaluation
# (2 epochs until the multi-device phases needed the time)
PRETRAIN_ARGV = ["--epochs", "1", "--num_cycles", "1"]
RESNET101_CIFAR100_PARAMS = 42_705_060
CIFAR_N = (50_000, 10_000)
# the mini ResNet held against its CPU run: the fixture cut to 256 training
# images (3 steps of 64 an epoch, as tests/test_torch_pretrain_cli.py runs
# the port against the JAX package)
CIFAR_CUT = (256, 64)
# the Pets layout at the published image size (500 x 375), cut from 3,680
# trainval and 3,669 test images to 512 and 256; demo_vision's defaults
# (pets, resnet101, batch 128) for 2 epochs of 1 cycle
PETS_N = (512, 256)
PETS_HW = (375, 500)
VISION_ARGV = ["--epochs", "2", "--num_cycles", "1"]
TIMED_IMAGES = 50  # per-image preprocessing times: the mean of this many


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """preprocess.cc's triangle filter (PIL's BILINEAR: the support widens
    with the scale on a downscale) as an [n_out, n_in] float32 matrix: each
    weight rounded to float, then divided by the row's float64 sum."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    w = np.zeros((n_out, n_in), np.float32)
    for o in range(n_out):
        center = (o + 0.5) * scale
        lo = max(int(center - fscale + 0.5), 0)
        hi = min(int(center + fscale + 0.5), n_in)
        x = (np.arange(lo, hi) + 0.5 - center) / fscale
        f = np.where(np.abs(x) < 1.0, 1.0 - np.abs(x), 0.0)
        total = f.sum()
        if total > 0:
            w[o, lo:hi] = (f.astype(np.float32).astype(np.float64)
                           / total).astype(np.float32)
    return w


def resize_plain(img: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """The library's resize in numpy: a horizontal then a vertical pass in
    float32 (BLAS sums in its own order), + 0.5 and truncated to uint8."""
    sh, sw = img.shape[:2]
    tmp = np.einsum("os,ysc->yoc", resize_weights(sw, dw),
                    img.astype(np.float32))
    acc = np.einsum("oy,yxc->oxc", resize_weights(sh, dh), tmp)
    return np.clip(acc + np.float32(0.5), 0, 255).astype(np.uint8)


def normalize_plain(window: np.ndarray, mean, std) -> np.ndarray:
    """crop_flip_normalize's arithmetic: (x * (1/255) - mean) * (1/std)."""
    inv = np.float32(1.0) / np.asarray(std, np.float32)
    return ((window.astype(np.float32) * np.float32(1.0 / 255.0)
             - np.asarray(mean, np.float32)) * inv).astype(np.float32)


def mean_ms(fn, n: int = TIMED_IMAGES) -> float:
    fn()
    tic = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - tic) / n * 1e3


def phase_host_probe(smi) -> dict:
    """7a: the host the card sits in: its cores, PIL, g++; the native
    preprocessing library (bayesdll_tpu_torch/native) built from the
    checkout, held against a numpy version of its arithmetic on seeded
    images, and timed per 500 x 375 image beside PIL's eval transform."""
    from bayesdll_tpu_torch import native
    from bayesdll_tpu_torch.data import vision_transforms as vt
    try:
        import PIL
        pil = f"PIL {PIL.__version__}"
    except ImportError:
        pil = None
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[:1]
    tic = time.perf_counter()
    ok = native.available()
    build_s = time.perf_counter() - tic
    print(f"phase 7a: host: nproc {os.cpu_count()}; "
          f"{pil or 'PIL does not import'}; g++: "
          f"{gxx[0] if gxx else 'none'}; native library "
          f"build/native/{native.library_path().name} "
          f"available={ok} ({build_s:.2f} s to build or load)", flush=True)
    check(ok, "native.available() on the card's host")
    mean, std = vt.IMAGENET_MEAN, vt.IMAGENET_STD
    rng = np.random.RandomState(7)
    level = 1.0 / (255.0 * float(std.min()))  # one uint8 step, normalised
    errs = []
    for hw, size in ((PETS_HW, 224), ((300, 280), 224), ((90, 70), 48)):
        img = rng.randint(0, 256, hw + (3,), np.uint8)
        top, left = 3, 5
        for flip in (False, True):
            got = native.crop_flip_normalize(img, top, left, size, flip,
                                             mean, std)
            win = img[top:top + size, left:left + size]
            want = normalize_plain(win[:, ::-1] if flip else win, mean, std)
            err = float(np.abs(got - want).max())
            check(err <= 1e-5, f"crop_flip_normalize {hw} flip={flip}: {err}")
            errs.append(err)
        resize_to = int(size * 256 / 224)
        got = native.eval_preprocess(img, mean, std, size=size,
                                     resize_to=resize_to)
        sh, sw = hw
        rh, rw = ((native._lround(sh * resize_to / sw), resize_to)
                  if sw < sh else (resize_to,
                                   native._lround(sw * resize_to / sh)))
        resized = resize_plain(img, rh, rw)
        t, lft = (rh - size) // 2, (rw - size) // 2
        want = normalize_plain(resized[t:t + size, lft:lft + size], mean, std)
        diff = np.abs(got - want)
        off = float((diff > 1e-5).mean())
        check(float(diff.max()) <= level + 1e-5 and off < 0.01,
              f"eval_preprocess {hw}: max {float(diff.max())}, {off:.4%} "
              "off by a level")
        errs.append(float(diff.max()))
    img = rng.randint(0, 256, PETS_HW + (3,), np.uint8)
    native_ms = mean_ms(lambda: native.eval_preprocess(img, mean, std))
    line = (f"phase 7a: [{smi}] native eval_preprocess {native_ms:.3f} "
            f"ms/image at {PETS_HW[1]}x{PETS_HW[0]} (resize 256 + crop 224 "
            f"+ normalise, one thread, mean of {TIMED_IMAGES}); "
            f"crop_flip_normalize within 1e-5 of numpy, eval_preprocess "
            f"within one uint8 level ({level:.4f}) of numpy's resize: max abs "
            f"err {max(errs):.3g}")
    out = {"native_ms": native_ms, "max_abs_err": max(errs),
           "has_pil": pil is not None}
    if out["has_pil"]:
        from PIL import Image
        pimg = Image.fromarray(img)
        out["pil_ms"] = mean_ms(lambda: vt.eval_transform(
            pimg, use_native=False))
        SCRATCH.mkdir(parents=True, exist_ok=True)
        jpg = SCRATCH / f"probe_{os.getpid()}.jpg"
        Image.fromarray(smooth_image(rng, PETS_HW)).save(jpg, quality=90)
        out["decode_ms"] = mean_ms(lambda: vt.load_image(str(jpg)).load())
        jpg.unlink()
        line += (f"; PIL eval_transform {out['pil_ms']:.3f} ms/image "
                 f"(native/PIL {native_ms / out['pil_ms']:.3f}); JPEG decode "
                 f"{out['decode_ms']:.3f} ms/image")
    print(line, flush=True)
    return out


def smooth_image(rng, hw) -> np.ndarray:
    """A photo-like uint8 image: a colour gradient, a soft blob and mild
    noise (JPEG sizes near a photo's)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    c0, c1 = rng.uniform(40, 215, (2, 3)).astype(np.float32)
    t = (xx / w)[..., None]
    img = c0 * (1 - t) + c1 * t
    cy, cx, r = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w, 0.2 * h
    blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None]
    img = img + blob * rng.uniform(-80, 80, 3).astype(np.float32)
    img += rng.normal(0, 6, img.shape).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_cifar100(root: Path, seed: int, n_train: int, n_test: int):
    """CIFAR-100's layout (cifar-100-python/{train,test}: b"data" [N, 3072]
    uint8, channel-major, and b"fine_labels"), with images a conv net can
    learn: class c is a grating of frequency pair c % 25 (1-5 cycles across
    each axis) in colour c // 25 (four random colours), at a random phase,
    plus N(0, 20) pixel noise."""
    rng = np.random.RandomState(seed)
    pairs = np.stack(np.meshgrid(np.arange(1, 6), np.arange(1, 6)),
                     -1).reshape(25, 2)
    colours = rng.uniform(-1, 1, (4, 3))
    ii, jj = np.mgrid[0:32, 0:32]
    base = root / "cifar-100-python"
    base.mkdir(parents=True, exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test)):
        y = rng.randint(0, 100, n)
        data = np.empty((n, 3, 32, 32), np.uint8)
        for s in range(0, n, 5000):
            yc = y[s:s + 5000]
            f = pairs[yc % 25]
            phase = rng.uniform(0, 2 * np.pi, len(yc))
            wave = np.sin(2 * np.pi * (f[:, 0, None, None] * ii
                                       + f[:, 1, None, None] * jj) / 32
                          + phase[:, None, None])
            img = (128 + 70 * colours[yc // 25][:, :, None, None]
                   * wave[:, None] + rng.normal(0, 20, (len(yc), 3, 32, 32)))
            data[s:s + 5000] = np.clip(img, 0, 255)
        with open(base / split, "wb") as fh:
            pickle.dump({b"data": data.reshape(n, 3072),
                         b"fine_labels": y.tolist()}, fh)


def cut_cifar100(src: Path, dst: Path, n_train: int, n_test: int):
    """The first n_train / n_test images of a CIFAR-100 folder, as another."""
    (dst / "cifar-100-python").mkdir(parents=True, exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test)):
        with open(src / "cifar-100-python" / split, "rb") as fh:
            d = pickle.load(fh)
        with open(dst / "cifar-100-python" / split, "wb") as fh:
            pickle.dump({b"data": d[b"data"][:n],
                         b"fine_labels": d[b"fine_labels"][:n]}, fh)


def write_pets(root: Path, seed: int, n_trainval: int, n_test: int):
    """oxford-iiit-pet/images/*.jpg at 500 x 375 with
    annotations/{trainval,test}.txt, 37 breeds, written by 8 threads."""
    from concurrent.futures import ThreadPoolExecutor
    from PIL import Image
    base = root / "oxford-iiit-pet"
    (base / "images").mkdir(parents=True, exist_ok=True)
    (base / "annotations").mkdir(parents=True, exist_ok=True)
    jobs = []
    for split, n in (("trainval", n_trainval), ("test", n_test)):
        names = [f"breed_{i % 37}_{split}_{i}" for i in range(n)]
        (base / "annotations" / f"{split}.txt").write_text("".join(
            f"{nm} {i % 37 + 1} 1 1\n" for i, nm in enumerate(names)))
        jobs += names

    def one(k):
        img = smooth_image(np.random.RandomState(seed * 100_003 + k),
                           PETS_HW)
        Image.fromarray(img).save(base / "images" / f"{jobs[k]}.jpg",
                                  quality=90)

    with ThreadPoolExecutor(8) as ex:
        list(ex.map(one, range(len(jobs))))


@contextlib.contextmanager
def watched_build(seen: dict, profile_epochs: bool = False):
    """The CLI's runner and loaders, kept in `seen` as build_all returns
    them, and the seconds of its cycle ends (the likelihood pass over the
    training set and the cycle's checkpoint, inside the last epoch of a
    cycle) in `seen["cycle_end_s"]`; with `profile_epochs`, each training
    epoch runs under torch.profiler and `seen["epochs"]` gets its (host s,
    device us)."""
    from torch.profiler import ProfilerActivity, profile
    from bayesdll_tpu_torch.cli import demo
    build_all = demo.build_all

    def watched(*a, **kw):
        runner, loaders = build_all(*a, **kw)
        seen["runner"], seen["loaders"] = runner, loaders
        seen["cycle_end_s"] = 0.0
        end_of_cycle = runner._end_of_cycle

        def timed_end_of_cycle(cycle):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            end_of_cycle(cycle)
            torch.cuda.synchronize()
            seen["cycle_end_s"] += time.perf_counter() - tic

        runner._end_of_cycle = timed_end_of_cycle
        if profile_epochs:
            one_epoch = runner.train_one_epoch
            seen["epochs"] = []

            def profiled(ep, loader):
                torch.cuda.synchronize()
                tic = time.perf_counter()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    out = one_epoch(ep, loader)
                    torch.cuda.synchronize()
                host = time.perf_counter() - tic
                dev = sum(_self_device(e) for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
                seen["epochs"].append((host, dev))
                return out

            runner.train_one_epoch = profiled
        return runner, loaders

    demo.build_all = watched
    try:
        yield seen
    finally:
        demo.build_all = build_all


EPOCH_LINE = re.compile(r"\[Epoch (\d+)/\d+\] Training summary: loss = (\S+), "
                        r"prediction error = (\S+) \(time: (\S+) seconds\)")


def epoch_lines(log: str) -> list:
    """(loss, training error, host seconds) of each epoch the CLI logged."""
    return [(float(m[2]), float(m[3]), float(m[4]))
            for m in EPOCH_LINE.finditer(log)]


def run_entry(main, argv, seen, profile_epochs=False):
    """An entry point's main on the card with every kernel's count set to 0
    just before and read just after: (results, log, counts, seconds)."""
    with watched_build(seen, profile_epochs):
        reset_launches()
        tic = time.perf_counter()
        res, log = entry_main(main, argv)
        torch.cuda.synchronize()
        secs = time.perf_counter() - tic
        counts = read_launches()
    return res, log, counts, secs


def loader_rate(loader) -> float:
    """Images/s of one pass over a loader (host only, no training)."""
    tic = time.perf_counter()
    n = sum(len(y) for _, y, _ in loader)
    return n / (time.perf_counter() - tic)


def phase_pretrain_cifar100(smi, root: Path) -> dict:
    """7b: ResNet-101 cSGHMC from scratch on the full-size CIFAR-100 fixture
    through `python -m bayesdll_tpu_torch.cli.pretrain`'s main, per step
    and fused (--fused_steps), cuDNN held to deterministic algorithms so
    that the two may agree bit for bit."""
    from bayesdll_tpu_torch.cli import pretrain
    from bayesdll_tpu_torch.ops import kernels
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    runs, by_path = {}, {}
    try:
        for fused in (False, True):
            label = "fused" if fused else "per step"
            logdir = tempfile.mkdtemp(prefix="pretrain_", dir=SCRATCH)
            seen = {}
            try:
                argv = PRETRAIN_ARGV + ["--data_root", str(root),
                                        "--log_dir", logdir]
                res, log, counts, secs = run_entry(
                    pretrain.main, argv + (["--fused_steps"] if fused else []),
                    seen)
            finally:
                shutil.rmtree(logdir, ignore_errors=True)
            runner = seen["runner"]
            train = seen["loaders"][0]
            cfg = runner.cfg
            check((cfg.method, cfg.backbone, cfg.dataset, cfg.batch_size,
                   cfg.lr, cfg.momentum, cfg.num_classes, cfg.device) ==
                  ("csghmc", "resnet101", "cifar100", 256, 0.1, 0.9, 100,
                   "cuda"), f"pretrain defaults: {cfg}")
            check(runner.target.n_params == RESNET101_CIFAR100_PARAMS,
                  f"resnet101, 100 classes: {runner.target.n_params}")
            steps = cfg.epochs * len(train)
            want = dict.fromkeys(kernels.launch_counts(), 0)
            want["csghmc_update"] = steps
            check(counts == want and runner.bi == steps,
                  f"pretrain {label}: launches {counts}, want {want}")
            epochs = epoch_lines(log)
            check(len(epochs) == cfg.epochs and all(
                math.isfinite(loss) for loss, _, _ in epochs),
                f"pretrain {label}: finite training losses {epochs}")
            check("nll" in res and math.isfinite(res["nll"]),
                  f"pretrain {label}: finite test NLL {res.get('nll')}")
            runs[label] = dict(res=res, epochs=epochs, secs=secs,
                               cycle_end_s=seen["cycle_end_s"],
                               steps=len(train), runner=runner, train=train,
                               theta=runner.state.theta.clone(),
                               v=runner.state.v.clone(),
                               stats=tree_clone(runner.net_state))
            by_path[f"csghmc resnet101 cifar100 {label}"] = counts
            if not fused:
                runs[label]["loader_aug"] = loader_rate(train.chain_view(0, 9))
                runs[label]["loader_plain"] = loader_rate(train.eval_view())
            print(f"phase 7b: [{smi}] pretrain {label}: resnet101 cSGHMC "
                  f"cifar100 ({len(train) * cfg.batch_size} of "
                  f"{train.num_examples} training images an epoch, "
                  f"{steps} steps) in {secs:.2f} s; launches {counts}; "
                  f"nll={res['nll']:.6g} test_err={res['test_err']:.4f}",
                  flush=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    a, b = runs["per step"], runs["fused"]
    for key in ("theta", "v"):
        check(torch.equal(a[key], b[key]), f"pretrain fused {key} bitwise: "
              f"max abs diff {float((a[key] - b[key]).abs().max())}")
    check(all(torch.equal(x, y) for x, y in zip(tree_leaves(a["stats"]),
                                                tree_leaves(b["stats"]))),
          "pretrain fused batch_stats bitwise")
    check(a["res"]["train_losses"] == b["res"]["train_losses"] and
          a["res"]["nll"] == b["res"]["nll"],
          f"pretrain fused losses bitwise: {a['res']['train_losses']} vs "
          f"{b['res']['train_losses']}")
    for label, run in runs.items():
        secs = [t for _, _, t in run["epochs"]]
        secs[-1] -= run["cycle_end_s"]
        host_ms = [t / run["steps"] * 1e3 for t in secs]
        bs = run["runner"].cfg.batch_size
        per_epoch = "; ".join(
            f"epoch {ep}: {ms:.2f} ms/step, {bs / ms * 1e3:.0f} images/s, "
            f"loss {loss:.4f}, training error {err:.4f}"
            for ep, (ms, (loss, err, _)) in enumerate(zip(host_ms,
                                                          run["epochs"])))
        print(f"phase 7b: [{smi}] pretrain {label} per epoch (host clock, "
              f"data loading and augmentation included, the cycle end's "
              f"{run['cycle_end_s']:.2f} s (likelihood pass over the training "
              f"set, nst=5, and the cycle's checkpoint) taken out of the "
              f"last): {per_epoch}", flush=True)
    print(f"phase 7b: [{smi}] fused equals per step bit for bit (θ, v, "
          f"batch_stats, training losses, NLL; cuDNN deterministic); CIFAR "
          f"train loader alone, batch 256, one thread: "
          f"{runs['per step']['loader_aug']:.0f} images/s with crop and "
          f"flip, {runs['per step']['loader_plain']:.0f} images/s without",
          flush=True)
    return by_path


def phase_cifar_reference(root: Path):
    """7b: the mini ResNet (stages 1,1,1,1) on the CIFAR-100 fixture cut to
    256 training images, cSGHMC at nd = 0 for 2 epochs through prepare and
    `train`, on the card against the same run on the CPU, fp32 with TF32
    off; bound as phase 3b's ResNet (gap <= 2% of the walk, >= 99% of
    elements within rtol 1e-4 atol 1e-5), the test NLL within rtol 1e-4."""
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.data import prepare
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models.resnet import ResNet
    cut = root.parent / "cifar_cut"
    cut_cifar100(root, cut, *CIFAR_CUT)
    out = {}
    for device in REF_DEVICES:
        cfg = Config(method="csghmc", hparams=dict(HP, nd="0.0", nst="0"),
                     dataset="cifar100", backbone="resnet_mini", epochs=2,
                     batch_size=64, lr=1e-3, num_cycles=1, seed=0,
                     val_heldout=0.02, data_root=str(cut), device=device)
        *loaders, nd = prepare(cfg)
        target, theta, ns = make_flat_target(
            ResNet(MINI["stages"], 100), nd_size=nd, num_classes=100,
            rng=torch.Generator().manual_seed(0), has_batch_stats=True,
            device=device)
        start = {"theta": theta.clone(), "v": torch.zeros_like(theta)}
        runner = get_runner_cls("csghmc")(target, theta, ns, cfg)
        res = runner.train(*loaders)
        out[device] = dict(theta=runner.state.theta, v=runner.state.v,
                           nll=res["nll"], steps=runner.bi)
    ref, card = (out[d] for d in REF_DEVICES)
    shown = []
    for key in ("theta", "v"):
        p, r, s0 = (flat_cpu(t) for t in (card[key], ref[key], start[key]))
        walked, gap = float((r - s0).norm()), float((p - r).norm())
        close = float(((p - r).abs() <= 1e-5 + 1e-4 * r.abs()).double().mean())
        check(walked > 0 and gap <= 2e-2 * walked and close >= 0.99,
              f"cifar mini resnet card vs CPU {key}: gap {gap:.3g}, walked "
              f"{walked:.3g}, {close:.4%} close")
        shown.append(f"{key} gap/walked {gap / walked:.3g}, {close:.4%} of "
                     "elements within rtol 1e-4 atol 1e-5")
    rel = abs(card["nll"] - ref["nll"]) / abs(ref["nll"])
    check(math.isfinite(card["nll"]) and rel <= 1e-4,
          f"cifar mini resnet NLL card {card['nll']} vs CPU {ref['nll']}")
    print(f"phase 7b: cifar100 fixture cut to {CIFAR_CUT[0]} + {CIFAR_CUT[1]}"
          f" images, ResNet stages (1,1,1,1) cSGHMC nd=0, {card['steps']} "
          f"steps of 64 with crop and flip, fp32, card vs CPU: "
          f"{'; '.join(shown)}; test NLL {card['nll']:.6g} vs "
          f"{ref['nll']:.6g} (rel {rel:.3g})", flush=True)


def phase_demo_vision(smi, root: Path) -> dict:
    """7c: the Pets-layout fixture through `python -m
    bayesdll_tpu_torch.cli.demo_vision`'s main (pets, resnet101, batch
    128), fp32 then bf16, each epoch profiled; and ImageFileLoader alone."""
    from bayesdll_tpu_torch.cli import demo_vision
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.data import prepare
    from bayesdll_tpu_torch.ops import kernels
    cfg = Config(dataset="pets", backbone="resnet101", batch_size=128,
                 data_root=str(root), device="cuda")
    train, _, test, nd = prepare(cfg)
    rates = {"train": loader_rate(train), "eval": loader_rate(test)}
    print(f"phase 7c: [{smi}] ImageFileLoader alone, {train.num_threads} "
          f"threads, batch 128, {PETS_HW[1]}x{PETS_HW[0]} JPEGs: train "
          f"(decode, random resized crop, flip, rotation) "
          f"{rates['train']:.1f} images/s over {len(train) * 128} images, "
          f"eval (decode, native resize and crop) {rates['eval']:.1f} "
          f"images/s over {test.num_examples}", flush=True)
    by_path = {}
    for dtype in ("float32", "bfloat16"):
        logdir = tempfile.mkdtemp(prefix="vision_", dir=SCRATCH)
        seen = {}
        try:
            res, log, counts, secs = run_entry(
                demo_vision.main, VISION_ARGV + [
                    "--data_root", str(root), "--log_dir", logdir,
                    "--compute_dtype", dtype, "--device", "cuda"],
                seen, profile_epochs=True)
        finally:
            shutil.rmtree(logdir, ignore_errors=True)
        runner = seen["runner"]
        steps = runner.cfg.epochs * len(seen["loaders"][0])
        want = dict.fromkeys(kernels.launch_counts(), 0)
        want["csghmc_update"] = steps
        check(counts == want, f"demo_vision {dtype}: launches {counts}")
        check((runner.cfg.dataset, runner.cfg.backbone,
               runner.cfg.num_classes) == ("pets", "resnet101", 37),
              f"demo_vision defaults: {runner.cfg}")
        epochs = epoch_lines(log)
        check(len(epochs) == 2 and all(math.isfinite(e[0]) for e in epochs)
              and math.isfinite(res.get("nll", math.nan)),
              f"demo_vision {dtype}: finite losses {epochs} and NLL")
        bs = runner.cfg.batch_size
        per_epoch = "; ".join(
            f"epoch {ep}: {host:.2f} s, {n / host:.1f} images/s, busy "
            f"{dev / (host * 1e6):.1%}"
            for ep, ((host, dev), n) in enumerate(zip(
                seen["epochs"], [len(seen["loaders"][0]) * bs] * 2)))
        by_path[f"csghmc resnet101 pets {dtype}"] = counts
        print(f"phase 7c: [{smi}] demo_vision {dtype}: {nd} training images,"
              f" {steps} steps of {bs} in {secs:.2f} s in all; launches "
              f"{counts}; nll={res['nll']:.6g} test_err={res['test_err']:.4f}"
              f"; per epoch (profiled, loader included; the last holds the "
              f"cycle end's {seen['cycle_end_s']:.2f} s, a likelihood pass "
              f"over the training images and a checkpoint): {per_epoch}",
              flush=True)
    return by_path


def phase_real_data(smi) -> dict:
    """Phase 7: the real-data paths (7a host and native library, 7b CIFAR-100
    through the pretraining CLI, 7c Pets through demo_vision where PIL
    imports), on fixtures written from seed 0 into a temporary directory
    under build/, deleted after."""
    probe = phase_host_probe(smi)
    SCRATCH.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="real_data_", dir=SCRATCH))
    try:
        tic = time.perf_counter()
        write_cifar100(tmp / "cifar", 0, *CIFAR_N)
        print(f"phase 7b: CIFAR-100 fixture ({CIFAR_N[0]:,} + {CIFAR_N[1]:,} "
              f"images, 100 grating classes) written in "
              f"{time.perf_counter() - tic:.1f} s", flush=True)
        by_path = phase_pretrain_cifar100(smi, tmp / "cifar")
        free_device()
        phase_cifar_reference(tmp / "cifar")
        if not probe["has_pil"]:
            print("phase 7c: not run: PIL does not import on this machine, so "
                  "no JPEG can be written or decoded here; the Pets and "
                  "ImageNet paths are held on the CPU by "
                  "tests/test_torch_vision_data.py", flush=True)
        else:
            tic = time.perf_counter()
            write_pets(tmp / "pets", 0, *PETS_N)
            print(f"phase 7c: Pets fixture ({PETS_N[0]} trainval + "
                  f"{PETS_N[1]} test JPEGs at {PETS_HW[1]}x{PETS_HW[0]}, 37 "
                  f"breeds) written in {time.perf_counter() - tic:.1f} s",
                  flush=True)
            by_path.update(phase_demo_vision(smi, tmp / "pets"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    free_device()
    return by_path


# ---- 8, checkpoints and traces ---------------------------------------------

# 8b: the full-width MLP's cSGHMC on 2 chains through the CLI (batch 128,
# lr 1e-3 as phase 3), cycles of one epoch so that the 1-epoch run and the
# 2-epoch runs share their schedule; 8c: the same on one chain, traced
CKPT_CLI = ["--method", "csghmc", "--backbone", "mlp_mnist",
            "--dataset", "synthetic", "--lr", "1e-3", "--device", "cuda",
            "--hparams", ",".join(f"{k}={v}" for k, v in HP.items())]
ONE_EPOCH = ["--epochs", "1", "--num_cycles", "1"]
TWO_EPOCHS = ["--epochs", "2", "--num_cycles", "2"]


def disk_gb(path: Path) -> float:
    files = [p for p in path.rglob("*") if p.is_file()] if path.is_dir() \
        else [path]
    return sum(p.stat().st_size for p in files) / 1e9


def synced_seconds(fn):
    """(fn(), seconds) with the card idle before and after."""
    torch.cuda.synchronize()
    tic = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - tic


def phase_vit_checkpoint(smi, runner, xs, ys):
    """8a: the trained ViT-L/32 cSGHMC state (the runner of phase 3) saved
    through utils.checkpoint (a DCP directory) and as the pickle payload
    (base.to_host), each restored on the card (the directory into a fresh
    state's own tensors, the pickle into new ones) and held bitwise with
    its counters; then one more step from the original and from each
    restore, csghmc_update launched once each, the states after it
    bitwise equal.  Seconds and GB/s of each save and restore, bytes on
    disk; the files are deleted."""
    from bayesdll_tpu_torch.methods import base
    from bayesdll_tpu_torch.utils import checkpoint as ckpt
    state = runner.state
    held = state_tensors(state)
    gb = sum(t.numel() * t.element_size() for t in held.values()) / 1e9
    SCRATCH.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="vit_l_32_state_", dir=SCRATCH))
    out, restored = {}, {}
    try:
        path, save_s = synced_seconds(
            lambda: ckpt.save(str(tmp / "chains_ckpt_orbax"), state))
        disk = disk_gb(Path(path))
        template = runner.init_state(torch.zeros(runner.target.dim,
                                                 device="cuda"))
        into = state_tensors(template)
        back, load_s = synced_seconds(lambda: ckpt.restore(path, template))
        check(all(state_tensors(back)[k] is t for k, t in into.items()),
              "vit_l_32: the directory restored into the template's tensors")
        shutil.rmtree(path)
        out["dcp"] = (save_s, load_s, disk)
        restored["dcp"] = back
        del template, into, back

        pkl = tmp / "state.pkl"

        def pickle_save():
            with open(pkl, "wb") as f:
                pickle.dump(base.to_host(state), f)

        def pickle_load():
            with open(pkl, "rb") as f:
                return base.from_host(state, pickle.load(f), runner.device)
        _, save_s = synced_seconds(pickle_save)
        disk = disk_gb(pkl)
        restored["pickle"], load_s = synced_seconds(pickle_load)
        pkl.unlink()
        out["pickle"] = (save_s, load_s, disk)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, st in restored.items():
        check(not differing(st, state), f"vit_l_32: the {name} round trip "
              f"bitwise, counts equal: {differing(st, state)}")
        check(all(t.is_cuda for t in state_tensors(st).values()),
              f"vit_l_32: the {name} restore on the card")

    ep, bi0 = runner.cfg.epochs - 1, runner.bi - 1
    after = {}
    for name, st in (("original", state), *restored.items()):
        reset_launches()
        with runner.bound(st, runner.net_state, runner.seed):
            runner.step_loop(ep, xs[:1], ys[:1], bi0)
            after[name] = runner.state
        torch.cuda.synchronize()
        counts = read_launches()
        check(counts["csghmc_update"] == 1 and sum(counts.values()) == 1,
              f"vit_l_32: one csghmc_update for the step from the {name} "
              f"state: {counts}")
    runner.state = after["original"]
    for name in restored:
        check(not differing(after[name], after["original"]),
              f"vit_l_32: the step from the {name} restore is the "
              f"original's: {differing(after[name], after['original'])}")
    del restored, after
    free_device()
    text = "; ".join(
        f"{name}: save {s:.2f} s ({gb / s:.2f} GB/s), restore {r:.2f} s "
        f"({gb / r:.2f} GB/s), {d:.3f} GB on disk"
        for name, (s, r, d) in out.items())
    print(f"phase 8a: [{smi}] vit_l_32 csghmc state D={runner.target.dim} "
          f"({len(held)} tensors, {gb:.3f} GB, counts "
          f"{host_counts(runner.state)}): {text}; both restores bitwise "
          "with equal counts, one more step from each bitwise equal to the "
          "original's (csghmc_update once each); files deleted", flush=True)


def chain_registries_equal(a, b) -> bool:
    """Two runs' per-chain cycle registries, bitwise."""
    if [sorted(s) for s in a] != [sorted(s) for s in b]:
        return False
    for sa, sb in zip(a, b):
        for cyc, st in sa.items():
            if set(st) != set(sb[cyc]):
                return False
            for k, v in st.items():
                w = sb[cyc][k]
                if not (np.array_equal(v, w) if isinstance(v, np.ndarray)
                        else v == w):
                    return False
    return True


def chains_differ(a, b) -> list:
    """What differs between two multi-chain runs: each chain's state
    (differing), the step, the cycle registries."""
    out = [(c, d) for c, (sa, sb) in enumerate(zip(a.trainer.states,
                                                  b.trainer.states))
           if (d := differing(sa, sb))]
    if a.trainer.bi != b.trainer.bi:
        out.append(("bi", a.trainer.bi, b.trainer.bi))
    if not chain_registries_equal(a.chain_cycle_stats, b.chain_cycle_stats):
        out.append("chain_cycle_stats")
    return out


def ckpt_cli(argv, logdir: str):
    """The CLI on 2 chains, the counts set to 0 just before and read just
    after: (its MultiChainRunner, counts)."""
    seen = {}
    with watched_multichain(seen):
        reset_launches()
        cli_main(CKPT_CLI + ["--num_chains", "2", "--log_dir", logdir]
                 + argv)
        torch.cuda.synchronize()
        counts = read_launches()
    return seen["mc"], counts


def graph_captures(mc) -> float:
    """Seconds of eager steps and captures of every chain's StepGraph."""
    r = mc.runner
    return sum(r._step_graphs[s].capture_s for s in mc.trainer.seeds
               if s in r._step_graphs)


def phase_chain_resume(smi, fused: bool, by_path: dict):
    """8b: 2-chain cSGHMC on the full-width MLP through the CLI with
    --ckpt_backend orbax: 1 epoch, then --resume <workdir>/
    chains_ckpt_orbax to 2 epochs, against the uninterrupted 2-epoch run;
    the pickle backend's resume from the same epoch against the
    directory's.  Every chain's state, the step and the cycle registries
    bitwise; launches = steps x chains.  Then, in the uninterrupted run's
    own runner, whose chains' graphs were captured (fused): the directory
    loaded in place and epoch 1 again, its graphs replayed and not captured
    again; the pickle loaded (new tensors) and epoch 1 again, captured
    again; both bitwise equal to the resumed runs."""
    tag = "fused" if fused else "per step"
    flags = ["--fused_steps"] if fused else []
    SCRATCH.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="chains_ckpt_", dir=SCRATCH))
    try:
        tic = time.perf_counter()
        runs, counts = {}, {}
        for name, argv in (("full", TWO_EPOCHS), ("int", ONE_EPOCH)):
            runs[name], counts[name] = ckpt_cli(
                argv + flags + ["--ckpt_backend", "orbax"], str(root / name))
        mc_int = runs["int"]
        directory = Path(mc_int.workdir) / "chains_ckpt_orbax"
        mc_int.cfg.ckpt_backend = "pickle"
        pkl = Path(mc_int.save_ckpt(0))
        sizes = {"orbax": disk_gb(directory), "pickle": disk_gb(pkl)}
        for backend, path in (("orbax", directory), ("pickle", pkl)):
            runs[backend], counts[backend] = ckpt_cli(
                TWO_EPOCHS + flags + ["--ckpt_backend", backend, "--resume",
                                      str(path)], str(root / backend))
        n = len(runs["full"]._train_loader)
        for name, epochs in (("full", 2), ("int", 1), ("orbax", 1),
                             ("pickle", 1)):
            c = counts[name]
            check(c["csghmc_update"] == epochs * n * 2
                  and sum(c.values()) == c["csghmc_update"],
                  f"8b {tag} {name}: launches {c} == {epochs} x {n} steps x "
                  "2 chains")
        for name, ref in (("orbax", "full"), ("pickle", "orbax")):
            diff = chains_differ(runs[name], runs[ref])
            check(not diff, f"8b {tag}: the {name} resume against the {ref} "
                  f"run: {diff}")
        by_path[f"csghmc mlp_mnist 2 chains orbax resume {tag}"] = \
            counts["orbax"]

        mc = runs["full"]
        loader = mc._train_loader
        inplace = {}
        for backend, path in (("orbax", directory), ("pickle", pkl)):
            ptrs = [t.data_ptr() for s in mc.trainer.states
                    for t in state_tensors(s).values()]
            captured = graph_captures(mc)
            mc.load_ckpt(str(path))
            same = ptrs == [t.data_ptr() for s in mc.trainer.states
                            for t in state_tensors(s).values()]
            reset_launches()
            mc.train(loader, None, None, start_epoch=1)
            torch.cuda.synchronize()
            c = read_launches()
            check(c["csghmc_update"] == n * 2,
                  f"8b {tag}: in-runner {backend} load, launches {c}")
            diff = chains_differ(mc, runs["orbax"])
            check(not diff, f"8b {tag}: epoch 1 after an in-runner {backend} "
                  f"load against the resumed run: {diff}")
            recaptured = graph_captures(mc) > captured
            check(same == (backend == "orbax"),
                  f"8b {tag}: the {backend} load keeps the chains' tensors: "
                  f"{same}")
            if fused:
                check(recaptured == (backend == "pickle"),
                      f"8b {tag}: after the {backend} load the graphs were "
                      f"{'captured again' if recaptured else 'replayed'}")
            inplace[backend] = ("in place" if same else "new tensors") + (
                (", captured again" if recaptured else ", replayed")
                if fused else "")
        secs = time.perf_counter() - tic
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 8b: [{smi}] csghmc mlp_mnist 2 chains {tag}, "
          f"{n} steps an epoch: 1 epoch then --resume from chains_ckpt_orbax "
          f"({sizes['orbax']:.4f} GB) to 2 epochs, bitwise equal to the "
          f"uninterrupted run (both chains' states and counts, bi, the cycle "
          f"registries); the pickle's resume (chains_ckpt.pkl, "
          f"{sizes['pickle']:.4f} GB) bitwise equal to it; launches "
          f"{ {k: v['csghmc_update'] for k, v in counts.items()} }; epoch 1 "
          f"again in the uninterrupted run's runner after a load: {inplace}, "
          f"bitwise; {secs:.1f} s", flush=True)


@contextlib.contextmanager
def cli_loaders(seen: dict):
    """The CLI's loaders, into seen["loaders"] as `build_all` makes them."""
    from bayesdll_tpu_torch.cli import demo
    build_all = demo.build_all

    def watched(*a, **kw):
        runner, loaders = build_all(*a, **kw)
        seen["loaders"] = loaders
        return runner, loaders

    demo.build_all = watched
    try:
        yield
    finally:
        demo.build_all = build_all


def launched_inside(events: list, kernel: str, program: list, name: str):
    """(launches of the trace's kernels whose name holds `kernel` that fall
    inside a program span named `name`, such kernels with a launch event,
    such kernels): a launch is the runtime call of the kernel's
    correlation, on the trace's timeline as the program's events are."""
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in program if e["ph"] == "X" and e["name"] == name)
    kernels = [e for e in events if e.get("cat") == "kernel"
               and kernel in e.get("name", "")]
    at = [launch[e["args"]["correlation"]] for e in kernels
          if e.get("args", {}).get("correlation") in launch]
    inside = sum(any(a <= t <= b for a, b in spans) for t in at)
    return inside, len(at), len(kernels)


def phase_cli_trace(smi, fused: bool):
    """8c: `cli.demo --profile_dir` on the MLP cSGHMC path for one epoch:
    the trace (TensorBoard's JSON) names csghmc_update, once a step per
    step (fused: what the trace shows of the replayed graphs is recorded),
    and launches = steps; the program file beside it, on the trace's
    `baseTimeNanoseconds`, holds the epoch and its steps (ids 0..n-1; fused,
    its segments), and each csghmc_update launch falls inside an `update`
    span (fused: inside a `fused.segment`, whose graphs replay the
    updates)."""
    tag = "fused" if fused else "per step"
    SCRATCH.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="cli_trace_", dir=SCRATCH))
    seen = {}
    try:
        with cli_loaders(seen):
            reset_launches()
            tic = time.perf_counter()
            cli_main(CKPT_CLI + ONE_EPOCH + (["--fused_steps"] if fused
                                            else [])
                     + ["--log_dir", str(root / "logs"),
                        "--profile_dir", str(root / "trace")])
            torch.cuda.synchronize()
            secs = time.perf_counter() - tic
            counts = read_launches()
        traces = list((root / "trace").glob("*.pt.trace.json"))
        check(len(traces) == 1, f"8c {tag}: one trace file: {traces}")
        side = traces[0].with_name(traces[0].name[:-len(".pt.trace.json")]
                                   + ".program.json")
        check(sorted((root / "trace").iterdir()) == sorted([traces[0], side]),
              f"8c {tag}: the trace and its program file: "
              f"{list((root / 'trace').iterdir())}")
        trace_mb = traces[0].stat().st_size / 1e6
        tic = time.perf_counter()
        with open(traces[0]) as f:
            doc = json.load(f)
        with open(side) as f:
            program = json.load(f)
        read_s = time.perf_counter() - tic
    finally:
        shutil.rmtree(root, ignore_errors=True)
    events, prog = doc["traceEvents"], program["traceEvents"]
    check(program["baseTimeNanoseconds"] == doc.get("baseTimeNanoseconds")
          and program["baseTimeNanoseconds"] > 0,
          f"8c {tag}: the program file's base "
          f"{program['baseTimeNanoseconds']} is the trace's "
          f"{doc.get('baseTimeNanoseconds')}")
    steps = len(seen["loaders"][0])
    kernel = [e for e in events if e.get("cat") == "kernel"]
    named = sum("csghmc_update_kernel" in e.get("name", "") for e in kernel)
    graph_launches = sum(e.get("name") == "cudaGraphLaunch" for e in events)
    check(counts["csghmc_update"] == steps,
          f"8c {tag}: launches {counts} == {steps} steps")
    if not fused:
        check(named == steps, f"8c {tag}: the trace names csghmc_update "
              f"{named} times, {steps} steps")
    spans = [e for e in prog if e["ph"] == "X"]
    by_name = collections.Counter(e["name"] for e in spans)
    (epoch,) = [e for e in spans if e["name"] == "epoch"]
    check(epoch["args"]["id"] == 0, f"8c {tag}: epoch id {epoch['args']}")
    step_ids = [e["args"]["id"] for e in spans if e["name"] == "step"]
    if fused:
        check(by_name["fused.segment"] >= 1,
              f"8c {tag}: fused segments in the program: {dict(by_name)}")
    else:
        check(step_ids == list(range(steps)),
              f"8c {tag}: step ids {step_ids[:5]}... of {steps} steps")
    unit = "fused.segment" if fused else "update"
    inside, launched, found = launched_inside(
        events, "csghmc_update_kernel", prog, unit)
    check(launched == found and inside == launched,
          f"8c {tag}: {inside} of {launched} csghmc_update launches "
          f"inside a span `{unit}` ({found} kernels in the trace)")
    replays = ""
    if fused:
        replays = (" (the eager steps and every replay)" if named == steps
                   else " (not every replay is in the trace)")
    print(f"phase 8c: [{smi}] cli.demo --profile_dir, csghmc mlp_mnist "
          f"{tag}, {steps} steps in {secs:.1f} s: trace {trace_mb:.1f} MB "
          f"(both files read back in {read_s:.2f} s), {len(kernel)} kernel "
          f"events, csghmc_update_kernel {named} times in {steps} steps"
          f"{replays}, cudaGraphLaunch {graph_launches}; launches "
          f"{counts['csghmc_update']}; program: {len(spans)} spans "
          f"{dict(by_name)}, {inside} of {launched} csghmc_update launches "
          f"inside `{unit}`", flush=True)


def phase_checkpoints_and_traces(smi, vit, xs, ys, by_path: dict):
    """8: checkpoints and traces."""
    tic = time.perf_counter()
    phase_vit_checkpoint(smi, vit, xs, ys)
    for fused in (False, True):
        phase_chain_resume(smi, fused, by_path)
    for fused in (False, True):
        phase_cli_trace(smi, fused)
    print(f"phase 8: [{smi}] checkpoints and traces in "
          f"{time.perf_counter() - tic:.1f} s", flush=True)


# ---- phase 9: multi-device ---------------------------------------------------

# 9a's shard counts, and the kernels' seed, step and gate there
SHARD_COUNTS = (2, 4)
SHARD_DRAW = dict(seed=(1 << 63) + 5, step=(1 << 32) + 9)


def shard_vectors(d: int) -> dict:
    """The operands of the five kernels at D: fp32 vectors on the card, lr
    head-free and positive, a 0/1 mask, Adam's moments."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    vec = {k: s * torch.randn(d, generator=gen, device="cuda")
           for k, s in (("g", 0.1), ("theta", 0.05), ("theta0", 0.05),
                        ("v", 0.01))}
    vec["lr"] = 1e-2 * (1.0 + torch.rand(d, generator=gen, device="cuda"))
    vec["mask"] = (torch.rand(d, generator=gen, device="cuda") > 0.1).float()
    vec["m"] = 0.01 * torch.randn(d, generator=gen, device="cuda")
    vec["v2"] = (1e-3 * torch.randn(d, generator=gen, device="cuda")).abs_()
    return vec


# what each kernel writes in place (philox_draw writes a new vector)
SHARD_WRITES = {"csghmc_update": ("theta", "v"), "sgld_update": ("g",),
                "sghmc_update": ("g", "v"), "philox_draw": (),
                "adam_sghmc_update": ("theta", "v", "m", "v2")}


def shard_call(name, vec, lo, hi):
    """`name`'s wrapper on vec's [lo, hi) at elem0 = lo, (seed, step, gate)
    from its row; returns the draw (philox_draw) or None."""
    from bayesdll_tpu_torch.ops import kernels
    a = {k: t[lo:hi] for k, t in vec.items()}
    dev = kernels.dev_scalars(SHARD_DRAW["seed"], SHARD_DRAW["step"], True)
    kw = dict(elem0=lo)
    if name == "csghmc_update":
        kernels.csghmc_update(a["g"], a["theta"], a["v"], a["lr"], dev,
                              prior_sig=1.0, alpha=0.05,
                              noise_pref=kernels.noise_prefactor(
                                  1.0, 0.05, 1000.0), **kw)
        return None
    if name == "philox_draw":
        return kernels.philox_draw(a["g"], dev, kind="normal",
                                   stream=kernels.STREAM_VI, **kw)
    if name == "adam_sghmc_update":
        kernels.adam_sghmc_update(
            a["g"], a["theta"], a["theta0"], a["v"], a["m"], a["v2"],
            a["mask"], a["lr"], adam_bc_row(), dev, n_eff=1000.0, nd=1.0,
            **ADAM_KW, **ADAM_FORMS["adam_csghmc"], **kw)
        return None
    sg = dict(prior_sig=1.0, n_eff=1000.0, nd=1.0, **kw)
    if name == "sgld_update":
        kernels.sgld_update(a["g"], a["theta"], a["theta0"], a["mask"],
                            a["lr"], dev, **sg)
    else:
        kernels.sghmc_update(a["g"], a["theta"], a["theta0"], a["v"],
                             a["mask"], a["lr"], dev, alpha=0.05, **sg)
    return None


def shard_run(name, vec, d, n):
    """n shard launches of `name` over copies of `vec`: the written vectors
    (or the draws) concatenated, and the launches counted."""
    out = {k: t.clone() for k, t in vec.items()}
    reset_launches()
    size = d // n
    draws = [shard_call(name, out, r * size, (r + 1) * size)
             for r in range(n)]
    torch.cuda.synchronize()
    counts = read_launches()
    if name == "philox_draw":
        return [torch.cat(draws)], counts
    return [out[k] for k in SHARD_WRITES[name]], counts


def phase_shard_kernels(smi, dims: dict) -> dict:
    """9a: each kernel on 2 and 4 shards of D at their global offsets
    against one whole-vector launch: bitwise, one launch per shard.
    Returns the launches."""
    from bayesdll_tpu_torch.ops import kernels
    tic = time.perf_counter()
    launches = {}
    for label, d in dims.items():
        vec = shard_vectors(d)
        for name in kernels.KERNELS:
            whole, _ = shard_run(name, vec, d, 1)
            for n in SHARD_COUNTS:
                got, counts = shard_run(name, vec, d, n)
                check(counts[name] == n and sum(counts.values()) == n,
                      f"9a {name} {n} shards: launches {counts}")
                same = all(torch.equal(a, b) for a, b in zip(got, whole))
                check(same, f"9a {name} at D={d}, {n} shards: the shards' "
                      "concatenation is not the whole launch")
                launches[name] = launches.get(name, 0) + n
            del whole
        del vec
        free_device()
    print(f"phase 9a: [{smi}] {', '.join(kernels.KERNELS)} on "
          f"{list(SHARD_COUNTS)} shards at their global "
          f"offsets, at D = {dims}: each concatenation bitwise equal to one "
          f"whole-vector launch (noise on, seed 2^63+5, step 2^32+9), one "
          f"launch per shard; {time.perf_counter() - tic:.1f} s", flush=True)
    return launches


def free_tcp_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


MULTIHOST_1 = ["--multihost", "--num_processes", "1", "--process_id", "0"]


@contextlib.contextmanager
def world_1():
    """The CLI's --multihost arguments for a world of one rank over NCCL
    (the card); the process group destroyed after."""
    import torch.distributed as dist
    try:
        yield MULTIHOST_1 + ["--coordinator", f"127.0.0.1:{free_tcp_port()}"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def chain_states_differ(a, b) -> list:
    """Chain c's differing tensors between two lists of states."""
    return [(c, d) for c, (sa, sb) in enumerate(zip(a, b))
            if (d := differing(sa, sb))]


def phase_world1_mlp(smi, by_path):
    """9b: 2-chain cSGHMC on the full-width MLP through the CLI, single
    process and as a world of one rank over NCCL (the process-group path:
    the ('chain', 'data') mesh, the gradient's all-reduce, the losses'
    gathers), per step and fused: every chain's state bitwise equal."""
    argv = CKPT_CLI + ["--num_chains", "2"] + ONE_EPOCH
    SCRATCH.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="world1_", dir=SCRATCH))

    def cli_run(name, flags, tag):
        seen = {}
        with watched_multichain(seen):
            reset_launches()
            cli_main(argv + flags + ["--log_dir", str(root / name)])
            torch.cuda.synchronize()
            counts = read_launches()
        mc = seen["mc"]
        check(counts["csghmc_update"] == 2 * len(mc._train_loader),
              f"9b mlp {name} {tag}: launches {counts}")
        check((mc.trainer.mesh is not None) == (name == "world 1"),
              f"9b mlp {name}: a mesh only in the world-1 run")
        return mc, counts
    try:
        for fused in (False, True):
            flags = ["--fused_steps"] if fused else []
            tag = "fused" if fused else "per step"
            runs = {"single": cli_run("single", flags, tag)[0]}
            with world_1() as extra:
                runs["world 1"], counts = cli_run("world 1", flags + extra,
                                                  tag)
                by_path[f"csghmc mlp_mnist 2 chains world 1 nccl {tag}"] = \
                    counts
                diff = chain_states_differ(runs["single"].trainer.states,
                                           runs["world 1"].trainer.states)
                check(not diff, f"9b mlp {tag}: single against world 1: "
                      f"{diff}")
                check(chain_registries_equal(
                    runs["single"].chain_cycle_stats,
                    runs["world 1"].chain_cycle_stats),
                    f"9b mlp {tag}: the cycle registries")
            del runs
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 9b: [{smi}] csghmc mlp_mnist 2 chains batch 128 through "
          f"the CLI, single process and --multihost world 1 over NCCL, per "
          f"step and fused: every chain's state and the cycle registries "
          f"bitwise equal", flush=True)


def vit_fsdp_runner(world: bool):
    """The ViT-L/32 cSGHMC multi-chain runner of 9b through the CLI's
    build_all: one chain, --fsdp, data_parallel 1; under a world of one
    rank over NCCL when `world`."""
    import logging

    from bayesdll_tpu_torch.cli import demo
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.parallel import init_distributed
    if world:
        init_distributed(f"127.0.0.1:{free_tcp_port()}", 1, 0)
    cfg = Config(method="csghmc", hparams=dict(VIT_HP), dataset="synthetic",
                 lr=VIT_LR, seed=0, device="cuda", fsdp=True,
                 mesh_shape={"chain": 1, "data": 1}, **VIT)
    mc, loaders = demo.build_all(cfg, logging.getLogger("chip_smoke.9b"))
    mc.runner._ensure_sched(len(loaders[0]))  # what train sets first
    check((mc.trainer.mesh is not None) == world
          and (mc.trainer.shard is not None
               and mc.trainer.shard.sharded) == world,
          f"9b vit: mesh and fsdp shard present = {world}")
    return mc, loaders


def phase_world1_vit(smi, by_path):
    """9b: ViT-L/32 cSGHMC (batch 128, bf16, full width) with --fsdp at
    data_parallel 1, single process and as a world of one rank over NCCL:
    3 steps per step, then a fused segment of 3, θ and v bitwise equal
    after each."""
    import torch.distributed as dist
    out = {}
    try:
        for name in ("single", "world 1"):
            mc, loaders = vit_fsdp_runner(name == "world 1")
            xs, ys = stacked_batches(loaders[0], 6)
            xs, ys = xs[:, None], ys[:, None]
            tr = mc.trainer
            reset_launches()
            tr.step_loop(0, xs[:3], ys[:3], 0)
            torch.cuda.synchronize()
            per_step = read_launches()
            snap = tr.full_state(0).theta.clone()
            reset_launches()
            tr.run_steps(0, xs[3:6], ys[3:6], 3)
            torch.cuda.synchronize()
            fused = read_launches()
            check(per_step["csghmc_update"] == 3
                  and fused["csghmc_update"] == 3,
                  f"9b vit {name}: launches {per_step} {fused}")
            if name == "world 1":
                by_path["csghmc vit_l_32 fsdp world 1 nccl"] = per_step
                by_path["csghmc vit_l_32 fsdp world 1 nccl fused"] = fused
            full = tr.full_state(0)
            out[name] = (snap, full.theta.clone(), full.v.clone())
            del full, snap, loaders, mc, tr, xs, ys
            free_device()
        same = [torch.equal(a, b)
                for a, b in zip(out["single"], out["world 1"])]
        check(all(same), f"9b vit: θ after the per-step steps, θ and v "
              f"after the fused segment, single against world 1: {same}")
        del out
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    free_device()
    print(f"phase 9b: [{smi}] csghmc vit_l_32 bf16 batch 128 --fsdp at "
          f"data_parallel 1, single process and world 1 over NCCL: θ after "
          f"3 per-step steps and θ, v after a fused segment of 3 bitwise "
          f"equal", flush=True)


# 9c: a rank of the CLI, one process each: the CLI's main with its runner
# kept, its kernel launches counted from 0, its first step's states and its
# final whole states (every chain's) written to a pickle
RANK_RUN = r'''
import json, pickle, sys, time
import torch
import bayesdll_tpu_torch.data as data
from bayesdll_tpu_torch.cli import demo
from bayesdll_tpu_torch.methods import base
from bayesdll_tpu_torch.ops import kernels
from bayesdll_tpu_torch.parallel import chains, runner as mcr
out_path, opts, argv = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3:]
cut = opts["cut"]
prepare = data.prepare
def cut_prepare(cfg):
    cfg.synthetic_n_train, cfg.synthetic_n_test = cut
    return prepare(cfg)
data.prepare = cut_prepare
seen = {}
train = mcr.MultiChainRunner.train
def keep(self, *a, **k):
    seen["mc"] = self
    return train(self, *a, **k)
mcr.MultiChainRunner.train = keep
if opts.get("no_checkpoints"):  # a run whose checkpoints no check reads
    base.BaseRunner.save_ckpt = lambda self, *a, **k: None
base_train = base.BaseRunner.train
def keep_single(self, *a, **k):
    seen.setdefault("single", self)
    seen.setdefault("loaders", a)
    return base_train(self, *a, **k)
base.BaseRunner.train = keep_single
step_local = chains.MultiChainTrainer._step_local
def first(self, *a, **k):
    out = step_local(self, *a, **k)
    if "first" not in seen:
        seen["first"] = [base.to_host(s) for s in self.all_chains()[0]]
    return out
chains.MultiChainTrainer._step_local = first
for name in kernels.KERNELS:
    getattr(kernels, name).launches = 0
tic = time.perf_counter()
res = demo.main(argv)
if torch.cuda.is_available():
    torch.cuda.synchronize()
out = {"counts": kernels.launch_counts(), "secs": time.perf_counter() - tic,
       "nll": res["nll"], "train_losses": res["train_losses"]}
if "mc" in seen:
    mc = seen["mc"]
    tr = mc.trainer
    out.update(states=[base.to_host(s) for s in tr.all_chains()[0]],
               local=[int(s.theta.shape[0]) for s in tr.states],
               first=seen.get("first"), workdir=mc.workdir)
    if opts.get("pickle"):  # the pickle beside the run's DCP directory
        mc.cfg.ckpt_backend = "pickle"
        out["pickle"] = mc.save_ckpt(mc.cfg.epochs - 1)
else:  # the tensor-parallel runner: its shard's length
    out.update(local=[int(seen["single"].state.theta.shape[0])])
    if opts.get("remat"):
        import chip_smoke
        out["remat"] = chip_smoke.rank_remat(seen["single"],
                                             seen["loaders"][0])
with open(out_path, "wb") as f:
    pickle.dump(out, f)
'''
# the synthetic sets of 9c's runs: (train, test) examples
MLP_CUT = (1024, 256)
VIT_CUT = (288, 128)  # 2 training batches of 128 after the val split


def launch_ranks(argv, logdir: Path, cut, started: list, **opts):
    """The CLI on 2 ranks sharing the card over gloo, joined by --multihost:
    (the processes, their output pickles, their logs); the processes are
    appended to `started` too.  opts: pickle=True saves the pickle beside a
    multi-chain run's DCP directory; remat=True runs `rank_remat` after a
    tensor-parallel run; no_checkpoints=True writes no single-chain
    checkpoint (ViT-L/32's are GB-sized, and no check reads them)."""
    port = free_tcp_port()
    return spawn_ranks(
        lambda r, out: ["-c", RANK_RUN, str(out),
                        json.dumps({"cut": list(cut), **opts}), *argv,
                        "--log_dir", str(logdir), "--multihost",
                        "--coordinator", f"127.0.0.1:{port}",
                        "--num_processes", "2", "--process_id", str(r),
                        "--dist_backend", "gloo", "--device", "cuda"],
        logdir, started)


def spawn_ranks(args_of, logdir: Path, started: list):
    """2 processes `python args_of(rank, output pickle)` from the
    repository root: (the processes, their output pickles, their logs);
    the processes are appended to `started` too."""
    logdir.mkdir(parents=True, exist_ok=True)
    outs = [logdir / f"rank{r}.pkl" for r in range(2)]
    logs = [logdir / f"rank{r}.log" for r in range(2)]
    procs = []
    for r in range(2):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, *args_of(r, outs[r])],
                cwd=Path(__file__).resolve().parent, stdout=f,
                stderr=subprocess.STDOUT))
    started.extend(procs)
    return procs, outs, logs


# a rank of 9d and 9e outside the CLI: chip_smoke's function argv[2] on
# the arguments pickled in argv[3] (hex), its result pickled to argv[1]
RANK_FN = r'''
import pickle, sys
import chip_smoke
out = getattr(chip_smoke, sys.argv[2])(*pickle.loads(bytes.fromhex(sys.argv[3])))
with open(sys.argv[1], "wb") as f:
    pickle.dump(out, f)
'''


def launch_fn(name: str, args: tuple, logdir: Path, started: list):
    """chip_smoke's `name`(port, rank, *args) on 2 ranks sharing the card:
    spawn_ranks' triple."""
    port = free_tcp_port()
    return spawn_ranks(
        lambda r, out: ["-c", RANK_FN, str(out), name,
                        pickle.dumps((port, r, *args)).hex()],
        logdir, started)


def wait_ranks(job, what: str, timeout: float = 300.0) -> list:
    """Both ranks' pickles; a rank that fails fails the phase (its log's
    end printed), the other rank stopped."""
    procs, outs, logs = job
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            print(f"9c {what} rank {r} log:\n{logs[r].read_text()[-6000:]}",
                  flush=True)
        raise RuntimeError(f"check failed: 9c {what}: ranks {bad} failed")
    out = []
    for path in outs:
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    return out


def host_trees_equal(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(host_trees_equal, a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(host_trees_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@contextlib.contextmanager
def cut_synthetic(cut):
    """The synthetic sets of this process's runs cut as RANK_RUN cuts the
    ranks'."""
    import bayesdll_tpu_torch.data as data
    prepare = data.prepare

    def cut_prepare(cfg):
        cfg.synthetic_n_train, cfg.synthetic_n_test = cut
        return prepare(cfg)
    data.prepare = cut_prepare
    try:
        yield
    finally:
        data.prepare = prepare


def single_reference(argv, cut, logdir: Path, first=False,
                     checkpoints=True):
    """The CLI in this process, single: (its runner, its first step's
    whole states when `first`, its results); without `checkpoints` a
    single-chain run writes none."""
    from bayesdll_tpu_torch.methods import base
    from bayesdll_tpu_torch.parallel import chains
    seen = {}
    step_local = chains.MultiChainTrainer._step_local
    save_ckpt = base.BaseRunner.save_ckpt
    if not checkpoints:
        base.BaseRunner.save_ckpt = lambda self, *a, **k: None

    def keep_first(self, *a, **k):
        out = step_local(self, *a, **k)
        if "first" not in seen:
            seen["first"] = [base.to_host(s) for s in self.all_chains()[0]]
        return out
    chains.MultiChainTrainer._step_local = keep_first
    try:
        with cut_synthetic(cut), watched_multichain(seen):
            res = cli_main(argv + ["--log_dir", str(logdir)])
    finally:
        chains.MultiChainTrainer._step_local = step_local
        base.BaseRunner.save_ckpt = save_ckpt
    return seen.get("mc"), seen.get("first"), res


CSGHMC_ND0 = ",".join(f"{k}={v}" for k, v in dict(HP, nd="0.0").items())
CLI_9C = ["--method", "csghmc", "--backbone", "mlp_mnist", "--dataset",
          "synthetic", "--lr", "1e-3", "--device", "cuda"]
HP_9C = ["--hparams", ",".join(f"{k}={v}" for k, v in HP.items())]
VIT_9C = ["--method", "csghmc", "--backbone", "vit_l_32", "--num_classes",
          "37", "--dataset", "synthetic", "--batch_size", "128",
          "--compute_dtype", "bfloat16", "--epochs", "1", "--num_cycles", "1",
          "--lr", str(VIT_LR), "--device", "cuda", "--hparams",
          ",".join(f"{k}={v}" for k, v in dict(VIT_HP, nst="1").items())]
# bf16 forward: TP sums each row-parallel product's partials in bf16 over
# the ranks, where one card sums them inside one product in fp32
VIT_TP_RTOL = 2e-2


def phase_two_ranks(smi, by_path) -> dict:
    """9c: two ranks sharing the card over gloo, each a CLI process with
    --multihost (NCCL refuses two ranks on one card): the full-width MLP
    cSGHMC with --data_parallel 2 at nd = 0 against the single-process
    step; with --fsdp at nd > 0 bitwise equal to the replicated data
    parallel run, each vector on a rank half of D; --num_chains 2 over the
    2 ranks, each chain bitwise its single-process run; a DCP save and
    resume at world 2 bitwise; ViT-L/32 at --tensor_parallel 2 for 2 steps
    against the single-process steps."""
    SCRATCH.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="two_ranks_", dir=SCRATCH))
    tic = time.perf_counter()
    info, started = {}, []
    try:
        nd0 = CLI_9C + ["--hparams", CSGHMC_ND0, "--num_chains", "1"]
        noisy = CLI_9C + HP_9C
        runs = {
            "dp nd0": (nd0 + ["--data_parallel", "2"] + ONE_EPOCH, MLP_CUT),
            "dp": (noisy + ["--data_parallel", "2"] + ONE_EPOCH, MLP_CUT),
            "fsdp": (noisy + ["--data_parallel", "2", "--fsdp"] + ONE_EPOCH,
                     MLP_CUT),
            "chains": (noisy + ["--num_chains", "2"] + ONE_EPOCH, MLP_CUT),
            "chains full": (noisy + ["--num_chains", "2"] + TWO_EPOCHS,
                            MLP_CUT),
        }
        jobs = {k: launch_ranks(a, root / k.replace(" ", "_"), c, started)
                for k, (a, c) in runs.items()}
        # 9d's source: 2 chains with --data_parallel 2 --fsdp, an epoch
        jobs["fsdp chains"] = launch_ranks(
            noisy + ["--num_chains", "2", "--data_parallel", "2", "--fsdp"]
            + ONE_EPOCH, root / "fsdp_chains", MLP_CUT, started, pickle=True)
        # 9e runs its remat runs in the same ranks after the CLI run
        tp = launch_ranks(VIT_9C + ["--tensor_parallel", "2"], root / "tp",
                          VIT_CUT, started, remat=True, no_checkpoints=True)
        # 9e's Laplace under TP (small) meanwhile
        la_tp = launch_fn("rank_la_tp", (), root / "la_tp", started)
        # the single-process references meanwhile (MultiChainRunner: a
        # single --fsdp run has nothing to shard and keeps the chains'
        # jitter)
        ref_nd0, ref_first, _ = single_reference(
            nd0 + ["--fsdp"] + ONE_EPOCH, MLP_CUT, root / "ref_nd0",
            first=True)
        ref_chains, _, _ = single_reference(
            noisy + ["--num_chains", "2"] + ONE_EPOCH, MLP_CUT,
            root / "ref_chains")
        out = {k: wait_ranks(j, k) for k, j in jobs.items()}
        d = ref_nd0.trainer.runner.target.dim
        n_steps = len(ref_nd0._train_loader)
        for k, ranks in out.items():
            check(host_trees_equal(ranks[0]["states"], ranks[1]["states"])
                  and ranks[0]["nll"] == ranks[1]["nll"],
                  f"9c {k}: the two ranks' whole states and NLL")
            n_chain = len(ranks[0]["states"])
            steps = len(ranks[0]["train_losses"]) * n_steps
            local_chains = 1 if k in ("chains", "chains full") else n_chain
            for r in ranks:
                check(r["counts"]["csghmc_update"] == steps * local_chains,
                      f"9c {k}: launches {r['counts']}, {steps} steps")
            by_path[f"csghmc mlp_mnist {k} 2 ranks gloo (rank 0)"] = \
                ranks[0]["counts"]
        # data parallel at nd = 0: the first step against the single step
        got = out["dp nd0"][0]["first"][0]["theta"]
        want = ref_first[0]["theta"]
        err = float(np.abs(got - want).max())
        check(np.allclose(got, want, rtol=1e-5, atol=1e-6),
              f"9c dp nd0: first step against single, max abs err {err}")
        final_err = float(np.abs(out["dp nd0"][0]["states"][0]["theta"]
                                 - base_theta(ref_nd0)).max())
        # fsdp bitwise equal to replicated data parallel, half of D each
        check(host_trees_equal(out["fsdp"][0]["states"],
                               out["dp"][0]["states"]),
              "9c fsdp against replicated data parallel at nd > 0")
        check(all(r["local"] == [d // 2] for r in out["fsdp"])
              and all(r["local"] == [d] for r in out["dp"]),
              f"9c local sizes fsdp {[r['local'] for r in out['fsdp']]}")
        # the chains over the ranks, each its single-process run
        ref_states = [host_state(s) for s in ref_chains.trainer.states]
        check(all(r["local"] == [d] for r in out["chains"])
              and host_trees_equal(out["chains"][0]["states"], ref_states),
              "9c 2 chains over 2 ranks against the single-process run")
        # 9d's ViT-L/32 state from 2 fsdp ranks to one process: the ranks
        # save while the TP ranks run
        vit_save = launch_fn("rank_vit_fsdp_save", (str(root / "vit_fsdp"),),
                             root / "vit_save", started)
        # DCP at world 2: resume the 1-epoch run to 2 epochs
        ckpt = Path(out["chains"][0]["workdir"]) / "chains_ckpt_orbax"
        check(ckpt.is_dir(), f"9c: {ckpt} is the DCP directory")
        resumed = launch_ranks(noisy + ["--num_chains", "2"] + TWO_EPOCHS
                               + ["--resume", str(ckpt)], root / "resumed",
                               MLP_CUT, started)
        out["resumed"] = wait_ranks(resumed, "resumed")
        check(host_trees_equal(out["resumed"][0]["states"],
                               out["chains full"][0]["states"])
              and out["resumed"][0]["nll"] == out["chains full"][0]["nll"],
              "9c DCP resume at world 2 against the uninterrupted run")
        by_path["csghmc mlp_mnist chains resumed 2 ranks gloo (rank 0)"] = \
            out["resumed"][0]["counts"]
        # 9d: the fsdp ranks' directory and pickle resumed at world 1
        info["9d"] = phase_restore_elsewhere(smi, out["fsdp chains"], root,
                                             by_path)
        info["9e_la"] = phase_la_tp(smi, wait_ranks(la_tp, "la tp"),
                                    la_tp_fisher())
        free_device()
        info["9d_vit"] = phase_vit_restore_elsewhere(
            smi, wait_ranks(vit_save, "vit fsdp save"), root)
        # ViT-L/32 TP 2 against its single-process steps (run meanwhile)
        _, _, ref_vit = single_reference(VIT_9C, VIT_CUT, root / "ref_vit",
                                         checkpoints=False)
        free_device()
        out["tp"] = wait_ranks(tp, "vit tp", timeout=600)
        tp_loss = out["tp"][0]["train_losses"][0]
        ref_loss = ref_vit["train_losses"][0]
        check(out["tp"][0]["train_losses"] == out["tp"][1]["train_losses"]
              and abs(tp_loss - ref_loss) <= VIT_TP_RTOL * abs(ref_loss),
              f"9c vit tp 2: loss {tp_loss} against single {ref_loss}")
        check(out["tp"][0]["counts"]["csghmc_update"] == 2
              and out["tp"][0]["local"] == [VIT_DIM // 2],
              f"9c vit tp 2: {out['tp'][0]['counts']}, local "
              f"{out['tp'][0]['local']}")
        by_path["csghmc vit_l_32 tensor_parallel 2 ranks gloo (rank 0)"] = \
            out["tp"][0]["counts"]
        info["9e_remat"] = phase_tp_remat(smi, out["tp"])
        info.update({"dp_nd0_first_err": err, "dp_nd0_epoch_err": final_err,
                     "vit_tp_loss": tp_loss, "vit_single_loss": ref_loss,
                     "secs": {k: round(v[0]["secs"], 1)
                              for k, v in out.items()}})
    finally:
        for p in started:  # every rank process ends with the phase
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    info["phase_s"] = time.perf_counter() - tic
    print(f"phase 9c: [{smi}] 2 gloo ranks sharing the card, each a CLI "
          f"process with --multihost: mlp_mnist cSGHMC --data_parallel 2 "
          f"nd=0 first step within rtol 1e-5 of the single step (max abs "
          f"err {info['dp_nd0_first_err']:.3g}; after the epoch "
          f"{info['dp_nd0_epoch_err']:.3g}); --fsdp bitwise equal to "
          f"replicated data parallel at nd=1, D/2 per rank; --num_chains 2 "
          f"over the ranks bitwise the single-process chains; DCP save and "
          f"resume at world 2 bitwise; vit_l_32 bf16 --tensor_parallel 2, "
          f"2 steps: loss {info['vit_tp_loss']:.6f} against "
          f"{info['vit_single_loss']:.6f} single; each run's seconds "
          f"{info['secs']}; {info['phase_s']:.1f} s", flush=True)
    return info


# ---- 9d and 9e: restore at another layout, TP with remat, Laplace under TP --

def state_hashes(state) -> dict:
    """sha256 of each tensor of a state, on the host (a rank's slices, or
    slices [lo, hi) of whole tensors given as (state, lo, hi))."""
    import hashlib
    state, lo, hi = state if isinstance(state, tuple) else (state, None, None)
    return {k: hashlib.sha256(t[lo:hi].contiguous().cpu().numpy().tobytes())
            .hexdigest() for k, t in state_tensors(state).items()}


def count_all_reduces(fn):
    """(fn(), the all-reduces the process group ran in it): gloo's and
    NCCL's collectives in a CPU profile (a recompute that reads a saved
    sum runs none)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, sum(e.name in ("gloo:all_reduce", "nccl:all_reduce")
                    for e in prof.events())


# 9e's remat runs of the tensor-parallel ViT-L/32 (label, remat, policy);
# where a remat run differs from the plain one, the plain run again, to see
# whether the card's kernels repeat their bits
REMAT_RUNS = (("plain", False, ""), ("remat", True, ""),
              ("remat names", True, "names"))
PLAIN_AGAIN = ("plain again", False, "")
REMAT_STEPS = 2


def rank_remat(runner, train_loader) -> dict:
    """9e, on each rank of the tensor-parallel ViT-L/32 run after its CLI
    run: from one copy of its state, REMAT_STEPS steps of each of
    REMAT_RUNS (and PLAIN_AGAIN where a remat run differs from the plain
    one) on the run's first batches; per run the losses, the all-reduces
    per step, the peak memory (max_memory_allocated) and the rank's θ
    after, with its largest difference from the plain run's."""
    import copy
    import itertools
    model = runner.target.module
    batches = [(runner._to_device(x), runner._to_device(y))
               for x, y, _ in itertools.islice(iter(train_loader),
                                               REMAT_STEPS)]
    start, bi = copy.deepcopy(runner.state), runner.bi
    first = 0  # the schedule's first steps, noise gate as the run's
    out, plain = {}, None
    runs = list(REMAT_RUNS)
    for label, remat, policy in runs:
        model.remat, model.remat_policy = remat, policy
        runner.state = copy.deepcopy(start)
        free_device()
        torch.cuda.reset_peak_memory_stats()

        def steps():
            losses = []
            reset_launches()
            for i, (x, y) in enumerate(batches, first):
                runner.bi = i
                sc = runner.step_scalars(0)
                runner.state, runner.net_state, (loss, _) = runner._step(
                    runner.state, runner.net_state, x, y, i, sc)
                losses.append(float(loss))
            torch.cuda.synchronize()
            return losses
        tic = time.perf_counter()
        losses, n_reduce = count_all_reduces(steps)
        theta = runner.state.theta.clone()
        plain = theta if plain is None else plain
        out[label] = {
            "losses": losses, "all_reduces_per_step": n_reduce / REMAT_STEPS,
            "launches": read_launches(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "secs": time.perf_counter() - tic,
            "theta_equal": bool(torch.equal(theta, plain)),
            "theta_max_diff": float((theta - plain).abs().max())}
        same = out[label]["theta_equal"] and losses == out["plain"]["losses"]
        if not same and PLAIN_AGAIN not in runs:
            runs.append(PLAIN_AGAIN)
    model.remat, model.remat_policy = False, ""
    runner.state, runner.bi = start, bi
    return out


def vit_fsdp_chain(workdir, mesh=None):
    """The ViT-L/32 cSGHMC runner of phase 3 as one chain of a
    MultiChainRunner checkpointing to the DCP directory: over `mesh` with
    fsdp, or in one process."""
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.parallel import MultiChainRunner
    cfg = Config(method="csghmc", hparams=dict(VIT_HP), dataset="synthetic",
                 lr=VIT_LR, seed=0, device="cuda", ckpt_backend="orbax",
                 **dict(VIT, epochs=1, num_cycles=1))
    cfg.synthetic_n_train, cfg.synthetic_n_test = VIT_CUT
    runner, _ = make_runner(cfg)
    return MultiChainRunner(runner, 1, workdir=workdir, fsdp=mesh is not None,
                            mesh=mesh)


def rank_vit_fsdp_save(port, rank, workdir) -> dict:
    """9d, on each of 2 gloo ranks sharing the card: the ViT-L/32 chain
    with fsdp over the 2 ranks, saved as the DCP directory; its slice's
    offset, length and hashes, and the save's seconds."""
    from bayesdll_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                     device="cuda")
    mc = vit_fsdp_chain(workdir, make_mesh(1, 2))
    shard = mc.trainer.shard
    path, secs = synced_seconds(lambda: mc.save_ckpt(0))
    return {"path": path, "save_s": secs, "elem0": shard.elem0,
            "size": shard.size, "hashes": state_hashes(mc.trainer.states[0])}


# 9e's Laplace under TP: ViT-B/16's widths at depth 2, fp32, 16 images,
# microbatches of 8 (two vmapped calls), from seed 0
LA_TP_VIT = dict(patch=16, dim=768, depth=2, heads=12, mlp_dim=3072,
                 image_size=224, num_classes=10, dtype="float32")
LA_TP_HP = {"prior_sig": "0.1", "Ninflate": "1.0", "bias": "informative",
            "nst": "2", "fisher_microbatch": "8"}
LA_TP_RTOL = 1e-4  # fp32, the products split over the model ranks


def la_tp_fisher(mesh=None) -> dict:
    """Laplace's stage-2 variances at θ_init of the ViT of LA_TP_VIT (over
    the tensor-parallel `mesh` when given), and their seconds."""
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.core.prior import make_flat_target
    from bayesdll_tpu_torch.data.loader import ArrayLoader
    from bayesdll_tpu_torch.methods import get_runner_cls
    from bayesdll_tpu_torch.models.vit import ViT
    from bayesdll_tpu_torch.parallel import (make_tp_constraints,
                                             shard_runner_for_tp)
    tp = None if mesh is None else make_tp_constraints(mesh)
    target, theta, ns = make_flat_target(
        ViT(**LA_TP_VIT, tp=tp), nd_size=16, num_classes=10,
        rng=torch.Generator().manual_seed(0), device="cuda")
    cfg = Config(method="la", hparams=dict(LA_TP_HP), dataset="synthetic",
                 backbone="vit_b_16", epochs=1, batch_size=8, lr=1e-3,
                 seed=0, device="cuda")
    runner = get_runner_cls("la")(target, theta, ns, cfg)
    if mesh is not None:
        runner = shard_runner_for_tp(runner, mesh)
    runner.map_theta = runner.state.theta
    rng_ = np.random.RandomState(0)
    hw = LA_TP_VIT["image_size"]
    loader = ArrayLoader(rng_.randn(16, hw, hw, 3).astype(np.float32),
                         rng_.randint(0, 10, 16), 8)
    post_vars, secs = synced_seconds(lambda: runner.estimate_variance(loader))
    return {"vars": post_vars.cpu().numpy(), "secs": secs}


def rank_la_tp(port, rank) -> dict:
    """9e, on each of 2 gloo ranks sharing the card: la_tp_fisher at
    --tensor_parallel 2."""
    from bayesdll_tpu_torch.parallel import init_distributed, make_tp_mesh
    init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                     device="cuda")
    # fp32 as in this process (phase 1): the patch convolution off TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return la_tp_fisher(make_tp_mesh(1, 2))


def resumed_reference(argv, cut, logdir: Path):
    """The CLI in this process (a world of one) resuming from --resume:
    (its runner, the chains' whole states just after the load, the
    results, the load's launches)."""
    from bayesdll_tpu_torch.methods import base
    from bayesdll_tpu_torch.parallel.runner import MultiChainRunner
    seen = {}
    load = MultiChainRunner.load_ckpt

    def keep_loaded(self, path):
        ep = load(self, path)
        seen["loaded"] = [base.to_host(s) for s in self.trainer.states]
        return ep
    MultiChainRunner.load_ckpt = keep_loaded
    reset_launches()
    try:
        with cut_synthetic(cut), watched_multichain(seen):
            res = cli_main(argv + ["--log_dir", str(logdir)])
    finally:
        MultiChainRunner.load_ckpt = load
    return seen["mc"], seen["loaded"], res, read_launches()


def phase_restore_elsewhere(smi, fsdp_ranks, root: Path, by_path) -> dict:
    """9d: the full-width MLP's 2 cSGHMC chains saved by 2 gloo ranks with
    --data_parallel 2 --fsdp after an epoch (`fsdp_ranks`, their DCP
    directory and pickle) resumed through the CLI in this process, a world
    of one, without --fsdp, for a second epoch: each restore bitwise the
    ranks' whole states, the directory's resume bitwise the pickle's."""
    saved = fsdp_ranks[0]["states"]
    check(host_trees_equal(fsdp_ranks[1]["states"], saved),
          "9d: the fsdp ranks' whole states")
    ckpt_dir = Path(fsdp_ranks[0]["workdir"]) / "chains_ckpt_orbax"
    check(ckpt_dir.is_dir() and fsdp_ranks[0]["pickle"],
          f"9d: {ckpt_dir} and the pickle written")
    with open(str(ckpt_dir) + ".meta.pkl", "rb") as f:
        layout = pickle.load(f)["layout"]
    check(layout == {"world": 2, "chain_axis": 1, "n_data": 2, "fsdp": True},
          f"9d: the sidecar's layout {layout}")
    out = {}
    argv = CLI_9C + HP_9C + ["--num_chains", "2"] + TWO_EPOCHS
    for name, path in (("dcp", ckpt_dir), ("pickle", fsdp_ranks[0]["pickle"])):
        tic = time.perf_counter()
        mc, loaded, res, counts = resumed_reference(
            argv + ["--resume", str(path)], MLP_CUT, root / f"resume_{name}")
        tr = mc.trainer
        steps = len(mc._train_loader)
        check(tr.mesh is None and not tr.fsdp and [
            int(s.theta.shape[0]) for s in tr.states] == [tr.runner.target.dim]
            * 2, f"9d {name}: one process, no fsdp, whole vectors")
        check(host_trees_equal(loaded, saved),
              f"9d {name}: the restore at world 1 against the ranks' states")
        check(counts["csghmc_update"] == 2 * steps,
              f"9d {name}: launches {counts}, {steps} steps x 2 chains")
        out[name] = {"end": [host_state(s) for s in tr.states],
                     "nll": res["nll"], "losses": res["train_losses"],
                     "secs": time.perf_counter() - tic, "counts": counts}
        by_path[f"csghmc mlp_mnist 2 chains resumed at world 1 from the "
                f"{name} of 2 fsdp ranks"] = counts
    check(host_trees_equal(out["dcp"]["end"], out["pickle"]["end"])
          and out["dcp"]["nll"] == out["pickle"]["nll"]
          and out["dcp"]["losses"] == out["pickle"]["losses"],
          "9d: the DCP resume at world 1 against the pickle's")
    check(not host_trees_equal(out["dcp"]["end"], saved),
          "9d: the resumed epoch moved the chains")
    d = out
    print(f"phase 9d: [{smi}] mlp_mnist 2 cSGHMC chains saved by 2 gloo "
          f"ranks with --data_parallel 2 --fsdp after an epoch, resumed "
          f"through the CLI in one process without --fsdp: the restored "
          f"states bitwise the ranks', the DCP resume bitwise the pickle's "
          f"(NLL {d['dcp']['nll']:.6f}, losses {d['dcp']['losses']}), "
          f"launches {d['dcp']['counts']['csghmc_update']} each; seconds "
          f"dcp {d['dcp']['secs']:.1f}, pickle {d['pickle']['secs']:.1f}",
          flush=True)
    return out


def phase_vit_restore_elsewhere(smi, ranks, root: Path) -> dict:
    """9d: the ViT-L/32 chain saved by 2 fsdp gloo ranks (`ranks`) restored
    in this process (one chain, no fsdp): seconds and GB/s of the restore,
    each rank's slice bitwise (sha256)."""
    path = ranks[0]["path"]
    mc = vit_fsdp_chain(str(root / "vit_world1"))
    free_device()
    ep, secs = synced_seconds(lambda: mc.load_ckpt(path))
    state = mc.trainer.states[0]
    for r in ranks:
        got = state_hashes((state, r["elem0"], r["elem0"] + r["size"]))
        check(got == r["hashes"], f"9d vit_l_32: rank at {r['elem0']}'s "
              f"slice restored bitwise at world 1")
    gb = sum(t.numel() * t.element_size()
             for t in state_tensors(state).values()) / 1e9
    del mc, state
    free_device()
    v = {"restore_s": secs, "gb": gb, "epoch": ep,
         "save_s": [r["save_s"] for r in ranks]}
    print(f"phase 9d: [{smi}] vit_l_32 cSGHMC chain ({v['gb']:.3f} GB) "
          f"saved by 2 fsdp gloo ranks in {v['save_s'][0]:.2f} and "
          f"{v['save_s'][1]:.2f} s, restored in one process in "
          f"{v['restore_s']:.2f} s ({v['gb'] / v['restore_s']:.2f} GB/s), "
          f"each rank's slice bitwise (sha256)", flush=True)
    return v


def phase_tp_remat(smi, tp_ranks) -> dict:
    """9e: the remat runs of the tensor-parallel ViT-L/32 ranks
    (rank_remat): each rank's remat runs against its plain run."""
    info = {}
    again = [r["remat"].get("plain again") for r in tp_ranks]
    plain_repeats = all(a is None or (
        a["theta_equal"] and a["losses"] == r["remat"]["plain"]["losses"])
        for a, r in zip(again, tp_ranks))
    for rank, r in enumerate(tp_ranks):
        runs = r["remat"]
        base_ = runs["plain"]
        for label in ("remat", "remat names"):
            got = runs[label]
            same = got["theta_equal"] and got["losses"] == base_["losses"]
            rel = max(abs(a - b) / abs(b) for a, b in
                      zip(got["losses"], base_["losses"]))
            # bitwise; or, where the plain run itself does not repeat its
            # bits (a kernel that sums in a varying order), within the TP
            # run's bf16 bound
            check(same or (not plain_repeats and rel <= VIT_TP_RTOL),
                  f"9e vit tp 2 rank {rank} {label}: losses {got['losses']} "
                  f"against {base_['losses']}, θ max diff "
                  f"{got['theta_max_diff']}")
        reduce = {k: v["all_reduces_per_step"] for k, v in runs.items()}
        depth = 24
        want = {"plain": 4 * depth + 3, "remat": 5 * depth + 3,
                "remat names": 5 * depth + 3,
                **({"plain again": 4 * depth + 3}
                   if "plain again" in runs else {})}
        text = "; ".join(
            f"{k}: losses {r['losses']}, {r['all_reduces_per_step']:g} "
            f"all-reduces/step, {r['launches']['csghmc_update']} "
            f"csghmc_update launches, peak {r['peak_gb']:.2f} GB, "
            f"{r['secs']:.1f} "
            f"s, θ equal {r['theta_equal']} (max diff "
            f"{r['theta_max_diff']:.3g})" for k, r in runs.items())
        print(f"phase 9e: [{smi}] vit_l_32 bf16 --tensor_parallel 2 rank "
              f"{rank}, {REMAT_STEPS} steps from one state, batch 128: "
              f"{text}", flush=True)
        check(reduce == want, f"9e vit tp 2 rank {rank}: all-reduces per "
              f"step {reduce}, want {want}")
        check(all(v["launches"] == {**{k: 0 for k in v["launches"]},
                                    "csghmc_update": REMAT_STEPS}
                  for v in runs.values()),
              f"9e vit tp 2 rank {rank}: csghmc_update once a step: "
              f"{[v['launches'] for v in runs.values()]}")
        info[rank] = runs
    info["plain_repeats"] = plain_repeats
    return info


def phase_la_tp(smi, ranks, single) -> dict:
    """9e: Laplace's stage-2 variances of the ViT-B/16-width model at depth
    2 under --tensor_parallel 2 (two gloo ranks) against this process's."""
    ref = single["vars"]
    out = {}
    for rank, r in enumerate(ranks):
        rel = float(np.max(np.abs(r["vars"] - ref) / np.abs(ref)))
        check(r["vars"].shape == ref.shape and rel <= LA_TP_RTOL,
              f"9e la tp 2 rank {rank}: variances within rtol {LA_TP_RTOL} "
              f"of the single process's: max rel err {rel}")
        out[rank] = {"max_rel_err": rel, "secs": r["secs"]}
    prior = float(LA_TP_HP["prior_sig"]) ** 2
    moved = float(np.mean(ref < 0.999 * prior))
    check(moved > 0.01, f"9e la: the Fisher moved {moved:.3%} of the "
          f"variances off the prior's")
    out["single_secs"], out["moved"] = single["secs"], moved
    print(f"phase 9e: [{smi}] la, vit_b_16 widths at depth 2, fp32, stage-2 "
          f"Fisher of 16 images (microbatch 8) under --tensor_parallel 2 "
          f"against one process: max rel err of the variances "
          f"{out[0]['max_rel_err']:.3g}, {out[1]['max_rel_err']:.3g} (bound "
          f"{LA_TP_RTOL}); {moved:.2%} moved off the prior; seconds "
          f"{out[0]['secs']:.2f} (TP rank 0), {single['secs']:.2f} (one "
          f"process)", flush=True)
    return out


def host_state(state):
    from bayesdll_tpu_torch.methods import base
    return base.to_host(state)


def base_theta(mc) -> np.ndarray:
    return host_state(mc.trainer.states[0])["theta"]


def phase_multi_device(smi, by_path: dict) -> dict:
    """9: the kernels on shards, the process-group path at world 1 over
    NCCL, and two ranks sharing the card over gloo."""
    tic = time.perf_counter()
    out = {"9a_launches": phase_shard_kernels(
        smi, {"mlp_mnist": full_width_target(1000)[0].dim,
              "vit_l_32": VIT_DIM})}
    phase_world1_mlp(smi, by_path)
    phase_world1_vit(smi, by_path)
    out["9c"] = phase_two_ranks(smi, by_path)
    print(f"phase 9: [{smi}] multi-device in "
          f"{time.perf_counter() - tic:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    tic0 = time.perf_counter()
    smi = phase_device()
    mlp_target = full_width_target(nd_size=1000)[0]
    resnet, resnet_loaders = resnet_runner()
    errs = {"csghmc_update": max(phase_kernels(mlp_target, "mlp_mnist"),
                                 phase_kernels(resnet.target, "resnet101")),
            **phase_sg_kernels()}
    flush = torch.zeros(64 * 2**20, device="cuda")  # 256 MB, 5x the L2
    draw = {"mlp_mnist": phase_draw_kernel(smi, mlp_target.dim, "mlp_mnist",
                                           flush)}
    runners, by_path = {}, {}
    for method, hp, lr, kernel in PATHS:
        runner, loaders, n = phase_path(method, hp, lr, kernel)
        runners[method] = (runner, loaders)
        by_path[f"{method} mlp_mnist"] = {kernel: n}
    for method in SMOKE:
        runner, loaders, counts = phase_method_path(method)
        runners[method] = (runner, loaders)
        by_path[f"{method} mlp_mnist"] = counts
    fused = {}
    for method in FUSED_KERNEL:
        reset_launches()
        fused[method] = phase_fused_path(method, *runners[method])
        by_path[f"{method} mlp_mnist fused"] = read_launches()
    for method in ("csghmc", "sgld", "sghmc"):
        phase_fused_trace(smi, method, *fused[method])
    del fused
    phase_la_prior_sig()
    chains = {}
    for method in CHAIN_SMOKE:
        by_path[f"{method} mlp_mnist {N_CHAINS} chains"], chains[method] = \
            phase_chain_path(method)
    for method in FUSED_KERNEL:
        reset_launches()
        phase_fused_chain_path(method, *chains[method])
        by_path[f"{method} mlp_mnist {N_CHAINS} chains fused"] = \
            read_launches()
    del chains
    by_path["csghmc resnet101"] = {
        "csghmc_update": phase_resnet_path(resnet, resnet_loaders)}
    phase_reference("csghmc", HP)
    phase_reference("sgld", SG_HP, momentum=0.5)
    phase_reference("sghmc", SG_HP, momentum=0.5)
    phase_new_references()
    phase_chain_reference("csghmc", HP, ("theta", "v"))
    phase_chain_reference("sghmc", SG_HP, ("theta", "buf", "v"), momentum=0.5)
    phase_resnet_reference("csghmc", HP)
    phase_resnet_reference("sgld", SG_HP)
    phase_fisher_reference()
    times = {"mlp_mnist": kernel_times_at(smi, mlp_target),
             "resnet101": kernel_times_at(smi, resnet.target,
                                          ("csghmc_update",))}
    for name, err in phase_kernels_at_dev_points(smi, mlp_target,
                                                 "mlp_mnist").items():
        errs[name] = max(errs.get(name, 0.0), err)
    del resnet, resnet_loaders, runners, runner, loaders
    free_device()
    by_path["la resnet50"] = phase_la_resnet50()
    free_device()
    for name in BIG_CONFIGS:
        mc, by_path[f"{name} resnet50"] = phase_big_chains(smi, name)
        del mc
        free_device()

    # ViT-L/32, alone on the card
    vit, vit_loaders = vit_runner()
    errs["csghmc_update"] = max(errs["csghmc_update"],
                                phase_kernels(vit.target, "vit_l_32"))
    free_device()
    by_path["csghmc vit_l_32"] = {
        "csghmc_update": phase_vit_path(vit, vit_loaders)}
    phase_vit_reference()
    times["vit_l_32"] = kernel_times_at(smi, vit.target)
    xs, ys = device_batches(vit_loaders[0])
    phase_checkpoints_and_traces(smi, vit, xs, ys, by_path)
    for name, err in phase_kernels_at_dev_points(smi, vit.target,
                                                 "vit_l_32").items():
        errs[name] = max(errs.get(name, 0.0), err)
    draw["vit_l_32"] = phase_draw_kernel(smi, vit.target.dim, "vit_l_32",
                                         flush)
    phase_fused_vit(vit, vit_loaders)
    by_path["adam_csghmc vit_l_32 fused"] = phase_fused_vit_adam(
        smi, vit, xs, ys)
    del vit, vit_loaders, xs, ys
    free_device()
    window_record = phase_window_attention(smi)
    free_device()
    by_path.update(phase_real_data(smi))
    free_device()
    phase_multi_device(smi, by_path)
    print(f"chip_smoke: [{smi}] every phase passed in "
          f"{time.perf_counter() - tic0:.1f} s", flush=True)

    # each kernel's launches and times on its main path: the ViT-L/32
    # cSGHMC path for csghmc_update, the SGLD and SGHMC paths for the
    # others, the VI path for philox_draw, the fused ViT-L/32 Adam-cSGHMC
    # path for adam_sghmc_update; every D each was timed at under
    # "times_by_path"
    main_path = {"csghmc_update": ("csghmc vit_l_32", "vit_l_32"),
                 "sgld_update": ("sgld mlp_mnist", "mlp_mnist"),
                 "sghmc_update": ("sghmc mlp_mnist", "mlp_mnist")}
    record = [{
        "name": name, "route": "cuda",
        "source": f"bayesdll_tpu_torch/csrc/{name}.cu",
        "replaces": f"bayesdll_tpu/ops/pallas_kernels.py:{REPLACES[name]}",
        "launches": by_path[main_path[name][0]][name],
        "max_abs_err": errs[name], **times[main_path[name][1]][name],
        "library_ms": None,
        "launches_by_path": {p: c[name] for p, c in by_path.items()
                             if name in c},
        "times_by_path": {p: t[name] for p, t in times.items() if name in t},
    } for name in REPLACES]
    vit_draw = draw["vit_l_32"]
    record.append({
        "name": "philox_draw", "route": "cuda",
        "source": "bayesdll_tpu_torch/csrc/philox_draw.cu",
        "replaces": DRAW_REPLACES,
        "launches": by_path["vi mlp_mnist"]["philox_draw"],
        "max_abs_err": max(d["max_abs_err"] for d in draw.values()),
        **{k: vit_draw[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "uniform_ms",
                                    "uniform_library_ms", "normal_to_uniform",
                                    "normal_share_of_bound")},
        "fp32_arithmetic": {p: d["fp32_arithmetic"] for p, d in draw.items()},
        "launches_by_path": {p: c["philox_draw"] for p, c in by_path.items()
                             if "philox_draw" in c},
        "times_by_path": draw,
    })
    record.append({
        "name": "adam_sghmc_update", "route": "cuda",
        "source": "bayesdll_tpu_torch/csrc/adam_sghmc_update.cu",
        "replaces": "none: the eager Adam-SGHMC momentum, its philox_draw "
                    "draw and the SGD step (bayesdll_tpu/ops/fused.py::"
                    "adam_sghmc_update has no Pallas kernel)",
        "launches": by_path["adam_csghmc vit_l_32 fused"]["adam_sghmc_update"],
        "max_abs_err": errs["adam_sghmc_update"],
        **times["vit_l_32"]["adam_sghmc_update"], "library_ms": None,
        "launches_by_path": {p: c["adam_sghmc_update"]
                             for p, c in by_path.items()
                             if "adam_sghmc_update" in c},
        "times_by_path": {p: t["adam_sghmc_update"] for p, t in times.items()
                          if "adam_sghmc_update" in t},
    })
    record.extend(window_record)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
