#!/usr/bin/env python3
"""Smoke test of the PyTorch port (bayesdll_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases, one line each:
  1. the card (nvidia-smi name and power limit), the kernel build from
     bayesdll_tpu_torch/csrc, fp32 matmuls pinned (TF32 off);
  2. every kernel against its plain PyTorch version at the main path's
     shapes (full-width mlp_mnist: D = 2,797,568), with its noise checked
     against the closed form;
  3. the main path: cSGHMC training of the full-width MNIST MLP
     (784 -> 3x1000 -> 10) on synthetic data, batch 128, 2 epochs, 2
     cycles, through the entry points a user calls, with every kernel
     launch counted; then a small run on the card held against the same
     run on the CPU;
  4. times with CUDA events: each kernel, its plain version, its bound,
     and the training step;
  5. the training step's device time by kernel (torch.profiler).
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


def phase_main_path():
    from bayesdll_tpu_torch.config import Config
    from bayesdll_tpu_torch.ops import kernels

    cfg = Config(method="csghmc", hparams=dict(HP), dataset="synthetic",
                 backbone="mlp_mnist", epochs=2, batch_size=128, lr=1e-3,
                 num_cycles=2, seed=0, device="cuda")
    # lr 1e-3: at the bench's 1e-2 the full-width MLP diverges on this
    # synthetic task within two epochs (the JAX package does the same), and
    # a collapsed model would hide a wrong step
    runner, loaders = make_runner(cfg)
    check(runner.target.n_params == 2_797_010, "full-width mlp_mnist")
    kernels.csghmc_update.launches = 0
    tic = time.perf_counter()
    res = runner.train(*loaders)
    torch.cuda.synchronize()
    secs = time.perf_counter() - tic
    launches = kernels.csghmc_update.launches
    steps = cfg.epochs * len(loaders[0])
    check(launches == steps, f"csghmc_update launches {launches} == steps {steps}")
    check(all(math.isfinite(x) for x in res["train_losses"]), "finite losses")
    for key in ("nll", "ece", "mce"):
        check(key in res and math.isfinite(res[key]), f"result {key}")
    done = sorted(c for c, s in runner.cycle_stats.items() if "likelihoods" in s)
    check(done == [1, 2], f"two completed cycles, got {done}")
    check(bool(torch.isfinite(runner.state.theta).all()), "finite theta")
    check(res["test_err"] < 0.5, f"test error {res['test_err']} well below "
          "chance (0.9)")
    print(f"phase 3: main path mlp_mnist D={runner.target.dim} "
          f"({runner.target.n_params} params), {steps} steps in {secs:.2f} s "
          f"incl. eval; csghmc_update launches={launches}; losses="
          f"{[round(x, 4) for x in res['train_losses']]}; nll={res['nll']:.4f} "
          f"ece={res['ece']:.4f} test_err={res['test_err']:.4f}; cycles={done}",
          flush=True)
    return runner, loaders, launches


def phase_reference():
    """A small run on the card against the same run on the CPU (nd = 0: no
    noise, so the two agree up to fp32 rounding)."""
    from bayesdll_tpu_torch.config import Config

    out = {}
    for device in ("cpu", "cuda"):
        cfg = Config(method="csghmc", hparams=dict(HP, nd="0.0", nst="0"),
                     dataset="synthetic", backbone="mlp_mnist", epochs=2,
                     batch_size=64, lr=2e-2, num_cycles=2, seed=0,
                     val_heldout=0.15, device=device)
        cfg.synthetic_n_train = 512
        cfg.synthetic_n_test = 256
        runner, loaders = make_runner(cfg, width=32, depth=2)
        res = runner.train(*loaders)
        out[device] = (res, runner.state.theta.cpu())
    (rc, tc), (rg, tg) = out["cpu"], out["cuda"]
    err = float((tg - tc).abs().max())
    check(torch.allclose(tg, tc, rtol=1e-4, atol=1e-5),
          f"card vs CPU theta after training: max abs err {err}")
    for key in ("nll", "ece"):
        check(abs(rg[key] - rc[key]) < 1e-3, f"card vs CPU {key}")
    print(f"phase 3b: width-32 run, card vs CPU: theta max abs err {err:.3g} "
          f"(rtol 1e-4, atol 1e-5); nll {rg['nll']:.5f} vs {rc['nll']:.5f}; "
          f"ece {rg['ece']:.5f} vs {rc['ece']:.5f}", flush=True)


def phase_times(smi, runner, loaders):
    from bayesdll_tpu_torch.ops import fused, kernels
    name = torch.cuda.get_device_name(0)
    target = runner.target
    g, theta, v, lr = csghmc_inputs(target, lr_body=1e-4, lr_head=2e-4)
    kw = dict(prior_sig=1.0, alpha=0.05)
    n_eff = float(target.nd_size)
    pref = kernels.noise_prefactor(1.0, kw["alpha"], n_eff)
    step = [0]

    def kern(gate):
        step[0] += 1
        kernels.csghmc_update(g, theta, v, lr, noise_pref=pref, gate=gate,
                              seed=0, step=step[0], **kw)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def plain():
        fused.csghmc_update(g, theta, v, n_eff=n_eff, nd=1.0, lr=lr,
                            should_sample=True, generator=gen, **kw)

    flush = torch.zeros(64 * 2**20, device="cuda")  # 256 MB, 5x the L2
    # plain, kernel, kernel, plain: compare within one call, in turns
    p1 = cuda_ms_cold(plain, 50, flush)
    k_on = cuda_ms_cold(lambda: kern(True), 200, flush)
    k_off = cuda_ms_cold(lambda: kern(False), 200, flush)
    p2 = cuda_ms_cold(plain, 50, flush)
    k_warm = cuda_ms(lambda: kern(True), 200)  # back to back: L2 holds part
    plain_ms = (p1 + p2) / 2
    nbytes = 24 * target.dim  # read g, theta, v, lr; write theta, v
    # ~10 flops of update + ~35 for Philox and Box-Muller per element, all
    # counted at the fp32 rate (a generous bound: integer ops run slower)
    nops = 45 * target.dim
    bytes_ms = nbytes / peak_bytes_per_s(name) * 1e3
    ops_ms = nops / FP32_PEAK * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"phase 4: [{smi}] csghmc_update D={target.dim}, L2 flushed "
          f"before each launch: kernel {k_on * 1e3:.2f} us (noise on), "
          f"{k_off * 1e3:.2f} us (noise off), {k_warm * 1e3:.2f} us back to "
          f"back; bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.1f} MB at "
          f"{peak_bytes_per_s(name) / 1e12:.2f} TB/s, {bound_by}) = "
          f"{bound_ms / k_on:.1%} of roofline; plain PyTorch "
          f"{plain_ms * 1e3:.2f} us ({p1 * 1e3:.2f}/{p2 * 1e3:.2f}); "
          f"{nbytes / (k_on * 1e-3) / 1e12:.2f} TB/s achieved", flush=True)

    # the training step at batch 128 through run_steps
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
    runner.run_steps(0, xs[:5], ys[:5], runner.bi)  # warm-up
    torch.cuda.synchronize()
    tic = time.perf_counter()
    loss_k, _ = runner.run_steps(0, xs, ys, runner.bi)
    torch.cuda.synchronize()
    dt = time.perf_counter() - tic
    check(bool(torch.isfinite(loss_k).all()), "finite losses in the timed steps")
    ms_step = dt / STEPS_TIMED * 1e3
    gevals = STEPS_TIMED * xs.shape[1] / dt
    print(f"phase 4: [{smi}] training step mlp_mnist batch {xs.shape[1]}: "
          f"{ms_step:.3f} ms/step over {STEPS_TIMED} run_steps steps = "
          f"{gevals:.0f} gradient-evals/s", flush=True)
    phase_profile(smi, runner, xs[:PROFILED_STEPS], ys[:PROFILED_STEPS],
                  ms_step)
    return dict(ms=k_on, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def phase_profile(smi, runner, xs, ys, ms_step):
    """Where a training step's device time goes: torch.profiler over a few
    run_steps steps, device time summed by kernel name.  The busy share
    divides the device time per step by the unprofiled ms/step."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        runner.run_steps(0, xs, ys, runner.bi)
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
        print("phase 5: profiler recorded no device time: breakdown not "
              "measured", flush=True)
        return
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    shares = "; ".join(f"{name[:60]} {us:.1f} us ({us / total:.1%})"
                       for name, us in top)
    print(f"phase 5: [{smi}] profile over {len(xs)} steps: device time "
          f"{total:.1f} us/step = {total / (ms_step * 1e3):.1%} busy of "
          f"{ms_step:.3f} ms/step; by kernel: {shares}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 1
    smi = phase_device()
    err = phase_kernels()
    runner, loaders, launches = phase_main_path()
    phase_reference()
    times = phase_times(smi, runner, loaders)
    print(json.dumps({"kernels": [{
        "name": "csghmc_update", "route": "cuda",
        "source": "bayesdll_tpu_torch/csrc/csghmc_update.cu",
        "replaces": "bayesdll_tpu/ops/pallas_kernels.py:80",
        "launches": launches, "max_abs_err": err, **times,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
