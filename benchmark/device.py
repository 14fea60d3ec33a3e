"""The card a run measures: the check that it is there, what the result
line says of it, and the check that nothing of JAX was loaded."""

from __future__ import annotations

import os
import subprocess
import sys

from benchmark import spec

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "bayesdll_tpu")


def set_cache_dirs(root=spec.ROOT):
    """Every build and kernel cache under the checkout's build/, at fixed
    paths, so that only a checkout's first run builds.  The port's own
    kernels build into build/torch_kernels/ already."""
    cache = os.path.join(str(root), "build", "bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)


def require_chips(n: int):
    """Raise unless a CUDA card is there, n of them or more."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the card "
                         "and reports nothing without one")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} cards, "
                         f"{torch.cuda.device_count()} found")


def forbidden_modules():
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    "unknown" where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.splitlines()[0] if out else "unknown"


def info(chips: int, peak_bytes: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}
