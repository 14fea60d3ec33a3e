"""Tracing and step timing (counterpart of bayesdll_tpu.utils.profiling).

The reference's only observability is coarse per-epoch wall clock
(reference `methods/sgld.py:88,104-113`).  Here:

  * `trace(logdir)`: a context manager around `torch.profiler` that writes a
    TensorBoard-loadable trace (`<worker>.<time>.pt.trace.json`, with the
    card's kernels when CUDA is available) into `logdir`;
  * `StepTimer`: online step-time stats (mean/p50/p95) whose samples end in
    a `torch.cuda.synchronize` of the fenced tensor's card, for steps/sec
    telemetry without a trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch


# --- hardware and model constants ------------------------------------------

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W
# power limit: bf16 on the tensor cores, and fp32 outside them
BF16_PEAK = 989e12
FP32_PEAK = 67e12

# Analytic forward FLOPs per example at 224^2 (the JAX package's constants):
# convs/matmuls only, 2 FLOPs per MAC; training step = 3x forward.
FWD_FLOPS_PER_EXAMPLE = {
    "resnet101": 15.7e9,       # 7.85 GMACs (torchvision profile)
    "resnet50": 8.2e9,         # 4.09 GMACs
    "vit_l_32": 30.5e9,        # 2 * 305M params * 50 tokens
    "vit_b_16": 33.8e9,        # 2 * 86M params * 197 tokens
}


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profiler trace of the block into `logdir`; no-op when logdir is None.
    It records the host's ops, and the card's kernels when CUDA is
    available."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


class StepTimer:
    def __init__(self):
        self.samples = []

    @contextlib.contextmanager
    def measure(self, result_to_fence=None):
        """Times the block; when `result_to_fence` is a CUDA tensor, the
        sample ends after a synchronize of its card."""
        t0 = time.perf_counter()
        yield
        if isinstance(result_to_fence, torch.Tensor) \
                and result_to_fence.is_cuda:
            torch.cuda.synchronize(result_to_fence.device)
        self.samples.append(time.perf_counter() - t0)

    def stats(self):
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {
            "steps": len(a),
            "mean_s": float(a.mean()),
            "p50_s": float(np.percentile(a, 50)),
            "p95_s": float(np.percentile(a, 95)),
            "steps_per_sec": float(1.0 / a.mean()),
        }
