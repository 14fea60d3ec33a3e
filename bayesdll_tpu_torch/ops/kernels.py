"""Hopper kernels written by hand (counterpart of
bayesdll_tpu/ops/pallas_kernels.py), built and bound without PyTorch's
extension builder.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface under `build/torch_kernels/`, at first use, and again when
its source or a shared header changes (the file name carries their hash).
The library is loaded with ctypes.  Nothing here runs at import: the CPU
tests import this module on machines with no nvcc and no card.

Each wrapper takes CUDA tensors only; on anything else it raises.  It counts
its launches in `<wrapper>.launches`, so a run can show that its main path
went through the kernel.  Each kernel reads the Philox seed, the step and
(for csghmc) the gate from `dev`, an int64 row (seed, step, gate) on the
card: `dev_scalars` copies host values there without the host waiting, and
the fused path's captured CUDA graph fills its own row before each replay.
A launch recorded into a graph counts once at the capture, and the graph's
runner (methods/graphed.py) sets the counts so that each replay adds its
launches (`launch_counts`, `set_launch_counts`; these carry the
window-attention kernels' counts too, ops/window_attention.py).  Every
wrapper takes `elem0`, the global index of its vectors' first element when
they are one rank's shard of a longer flat vector (`check_offset`): the
noise is then that of the shard's own elements in the whole vector's draw,
so the shards' launches concatenate to one whole-vector launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from bayesdll_tpu_torch.ops import window_attention

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("csghmc_update", "sgld_update", "sghmc_update", "philox_draw",
           "adam_sghmc_update")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
_U64 = (1 << 64) - 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> float:
    """Compile every library in `names` that is missing, one nvcc process
    per source, all started together.  Returns the seconds taken."""
    tic = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - tic


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return lib


_P, _I64, _F = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
# each kernel's C prototype (csrc/<name>.cu); dev is the int64 row
_ARGTYPES = {
    # g, theta, v, lr, n, elem0, prior_sig, 1-alpha, noise_pref, dev, stream
    "csghmc_update": [_P, _P, _P, _P, _I64, _I64, _F, _F, _F, _P, _P],
    # g, theta, theta0, mask, lr, n, elem0, sigma^2, N, nd, dev, stream
    "sgld_update": [_P, _P, _P, _P, _P, _I64, _I64, _F, _F, _F, _P, _P],
    # g, theta, theta0, v, mask, lr, n, elem0, sigma^2, N, nd, 1-alpha,
    # 2 alpha, dev, stream
    "sghmc_update": [_P, _P, _P, _P, _P, _P, _I64, _I64, _F, _F, _F, _F, _F,
                     _P, _P],
    # out, n, elem0, kind, stream id, dev, stream
    "philox_draw": [_P, _I64, _I64, ctypes.c_int, ctypes.c_uint32, _P, _P],
    # g, theta, theta0, mask, lr, v_mom, m, v2, n, elem0, form, 1/T, 1/sigma^2,
    # 1/N, nd, b1, 1-b1, b2, 1-b2, eps, 1-alpha, 2 alpha, bc, dev, stream
    "adam_sghmc_update": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                          ctypes.c_int, *[_F] * 11, _P, _P, _P],
}
DEV_SCALARS = 3  # (seed, step, gate), the kernels' int64 row
# philox_draw's stream ids (csrc/normal_from_bits.cuh): one for each method
# step that draws a whole vector; 0-2 are the update kernels' own
STREAM_VI, STREAM_ADAM, STREAM_MC_DROPOUT = 3, 4, 5
DRAW_STREAMS = (STREAM_VI, STREAM_ADAM, STREAM_MC_DROPOUT)
DRAW_KINDS = {"normal": 0, "uniform": 1}


def seed_int64(seed: int) -> int:
    """The seed's 64 bits as an int64 (two's complement), as the kernels
    read it."""
    s = int(seed) & _U64
    return s - (1 << 64) if s >> 63 else s


def dev_scalars(seed: int, step: int, gate: bool = False, device="cuda"):
    """The int64 row (seed, step, gate) the kernels read, on `device`.  On
    a card it is filled in pinned host memory and copied without the host
    waiting: PyTorch's caching host allocator keeps the pinned block until
    the copy has run."""
    return _row([seed_int64(seed), int(step), int(bool(gate))], torch.int64,
                device)


def bias_row(bc1: float, bc2: float, device="cuda"):
    """The fp32 row (bc1, bc2) of Adam's bias corrections that
    adam_sghmc_update reads, on `device`, copied as dev_scalars copies."""
    return _row([bc1, bc2], torch.float32, device)


def _row(values, dtype, device):
    """`values` as a 1-D tensor on `device`; to a card from pinned host
    memory, without the host waiting."""
    device = torch.device(device)
    row = torch.tensor(values, dtype=dtype, pin_memory=device.type == "cuda")
    return row.to(device, non_blocking=True)


def _check_vectors(**tensors: torch.Tensor) -> torch.Tensor:
    """Every tensor a contiguous 1-D fp32 CUDA vector of one length on one
    device, 16-byte aligned (the kernels use float4 accesses)."""
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name}: kernel needs a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: kernel needs float32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: kernel needs a contiguous 1-D tensor")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device} "
                             f"differs from {tuple(first.shape)} on {first.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: kernel needs a 16-byte aligned pointer")
    return first


def _check_no_overlap(written: dict, read: dict):
    """No tensor a kernel writes may share memory with another operand."""
    spans = {k: (t.data_ptr(), t.data_ptr() + t.numel() * t.element_size())
             for k, t in {**read, **written}.items()}
    for w in written:
        for other, (lo, hi) in spans.items():
            if other != w and spans[w][0] < hi and lo < spans[w][1]:
                raise ValueError(f"{w} must not alias {other}")


def _check_dev(dev: torch.Tensor, like: torch.Tensor):
    """The kernels' scalars: a contiguous int64 tensor of DEV_SCALARS
    elements on the vectors' device."""
    if not dev.is_cuda or dev.device != like.device:
        raise ValueError(f"dev: kernel needs the scalars on {like.device}, "
                         f"got {dev.device}")
    if dev.dtype != torch.int64 or dev.numel() != DEV_SCALARS \
            or not dev.is_contiguous():
        raise ValueError(f"dev: kernel needs a contiguous int64 tensor of "
                         f"{DEV_SCALARS} elements, got {dev.dtype} "
                         f"{tuple(dev.shape)}")
    if dev.data_ptr() % 8:
        raise ValueError("dev: kernel needs an 8-byte aligned pointer")


def check_offset(elem0: int, n: int) -> int:
    """A launch's global element offset (csrc/normal_from_bits.cuh): a
    non-negative multiple of 4 with every global element quad of the
    launch below 2^32, the Philox counter word that holds it."""
    elem0 = int(elem0)
    if elem0 < 0 or elem0 % 4:
        raise ValueError(f"elem0 {elem0} is not a non-negative multiple of 4")
    if (elem0 + n + 3) // 4 > 1 << 32:
        raise ValueError(f"elements [{elem0}, {elem0 + n}) pass the 2^32 "
                         f"element quads of the Philox counter word")
    return elem0


def launch_counts() -> dict:
    """Every kernel's launch count, the window-attention kernels'
    (ops/window_attention.py) included."""
    return {**{name: globals()[name].launches for name in KERNELS},
            **window_attention.launch_counts()}


def set_launch_counts(counts: dict):
    for name, n in counts.items():
        if name in KERNELS:
            globals()[name].launches = n
    window_attention.set_launch_counts(counts)


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def csghmc_update(g, theta, v, lr, dev, *, prior_sig: float, alpha: float,
                  noise_pref: float, elem0: int = 0):
    """cSGHMC update on the card, IN PLACE on theta and v (csrc/csghmc_update.cu):

        v     <- (1 - alpha) v - lr * (g + prior_sig * theta)
                 + gate * noise_pref * sqrt(lr) * z
        theta <- theta + v

    noise_pref = nd * sqrt(2 alpha) / N; `dev` is the int64 row (seed,
    step, gate) on the card (`dev_scalars`); z is Philox noise keyed by the
    seed at counter `step`, of global elements [elem0, elem0 + n) (the
    vectors a shard of a longer one at that offset).  Returns (theta, v).
    """
    _check_vectors(g=g, theta=theta, v=v, lr=lr)
    _check_no_overlap(dict(theta=theta, v=v), dict(g=g, lr=lr))
    _check_dev(dev, theta)
    lib = _library("csghmc_update")
    with torch.cuda.device(theta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.csghmc_update(
            g.data_ptr(), theta.data_ptr(), v.data_ptr(), lr.data_ptr(),
            theta.numel(), check_offset(elem0, theta.numel()),
            float(prior_sig), float(1.0 - alpha), float(noise_pref),
            dev.data_ptr(), stream)
    _raise_on(err, "csghmc_update")
    csghmc_update.launches += 1
    return theta, v


csghmc_update.launches = 0


def sgld_update(g, theta, theta0, mask, lr, dev, *, prior_sig: float,
                n_eff: float, nd: float, elem0: int = 0):
    """SGLD crafted gradient on the card, IN PLACE on g (csrc/sgld_update.cu):

        g <- g + mask * (theta - theta0) / prior_sig^2 / N
               + nd * sqrt(2 / (N * max(lr, 1e-30))) * z

    z is Philox noise keyed by the seed of `dev` (int64 [3], the last
    unused) at counter `step`, of global elements [elem0, elem0 + n).
    Returns g.
    """
    _check_vectors(g=g, theta=theta, theta0=theta0, mask=mask, lr=lr)
    _check_no_overlap(dict(g=g), dict(theta=theta, theta0=theta0, mask=mask,
                                      lr=lr))
    _check_dev(dev, g)
    lib = _library("sgld_update")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sgld_update(
            g.data_ptr(), theta.data_ptr(), theta0.data_ptr(), mask.data_ptr(),
            lr.data_ptr(), g.numel(), check_offset(elem0, g.numel()),
            float(prior_sig ** 2), float(n_eff), float(nd), dev.data_ptr(),
            stream)
    _raise_on(err, "sgld_update")
    sgld_update.launches += 1
    return g


sgld_update.launches = 0


def sghmc_update(g, theta, theta0, v, mask, lr, dev, *, prior_sig: float,
                 n_eff: float, nd: float, alpha: float, elem0: int = 0):
    """SGHMC momentum update on the card, IN PLACE on g and v
    (csrc/sghmc_update.cu), with lr clamped at 1e-30:

        v <- (1 - alpha) v + lr * (g + mask * (theta - theta0) / prior_sig^2 / N)
             + nd * sqrt(2 alpha / (N * lr)) * z
        g <- g + v

    z is Philox noise keyed by the seed of `dev` (int64 [3], the last
    unused) at counter `step`, of global elements [elem0, elem0 + n).
    Returns (g, v).
    """
    _check_vectors(g=g, theta=theta, theta0=theta0, v=v, mask=mask, lr=lr)
    _check_no_overlap(dict(g=g, v=v), dict(theta=theta, theta0=theta0,
                                           mask=mask, lr=lr))
    _check_dev(dev, g)
    lib = _library("sghmc_update")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sghmc_update(
            g.data_ptr(), theta.data_ptr(), theta0.data_ptr(), v.data_ptr(),
            mask.data_ptr(), lr.data_ptr(), g.numel(),
            check_offset(elem0, g.numel()), float(prior_sig ** 2),
            float(n_eff), float(nd), float(1.0 - alpha), float(2.0 * alpha),
            dev.data_ptr(), stream)
    _raise_on(err, "sghmc_update")
    sghmc_update.launches += 1
    return g, v


sghmc_update.launches = 0


def _check_bc(bc: torch.Tensor, like: torch.Tensor):
    """Adam's bias corrections: a contiguous fp32 tensor of 2 elements on
    the vectors' device."""
    if not bc.is_cuda or bc.device != like.device:
        raise ValueError(f"bc: kernel needs the bias corrections on "
                         f"{like.device}, got {bc.device}")
    if bc.dtype != torch.float32 or bc.numel() != 2 or not bc.is_contiguous():
        raise ValueError(f"bc: kernel needs a contiguous float32 tensor of 2 "
                         f"elements, got {bc.dtype} {tuple(bc.shape)}")


def _f32(x: float) -> float:
    return float(np.float32(x))


def _recip32(x: float) -> float:
    """1 / x as PyTorch on the card divides by a host scalar: the fp32
    reciprocal of x rounded to fp32."""
    return float(np.float32(1.0) / np.float32(x))


def adam_sghmc_update(g, theta, theta0, v_mom, m, v2, mask, lr, bc, dev, *,
                      prior_sig: float, n_eff: float, nd: float,
                      alpha: float, beta1: float, beta2: float,
                      eps_adam: float, temperature: float = 1.0,
                      add_g: bool, sgd_step: bool, elem0: int = 0):
    """Adam-SGHMC's momentum on the card, IN PLACE on v_mom, m and v2
    (csrc/adam_sghmc_update.cu), in ops/fused.py::adam_sghmc_momentum's
    arithmetic and rounding:

        grad_U = g / T + mask * (theta - theta0) / prior_sig^2 / N
        m  <- b1 m + (1 - b1) grad_U;   v2 <- b2 v2 + (1 - b2) grad_U^2
        P   = 1 / (sqrt(v2 / bc2) + eps)
        v_mom <- (1 - alpha) v_mom + lr (m / bc1) P + nd sqrt(2 alpha P / N) z

    then SGD's gradient s = g + v_mom (`add_g`, Adam-SGHMC) or v_mom
    (Adam-cSGHMC): with `sgd_step` the torch-SGD step at momentum 0,
    theta <- theta - lr s, in the same pass; without it s is left for the
    eager step, written over g where `add_g`.  `bc` is the fp32 row (1 -
    b1^t, 1 - b2^t) on the card (`bias_row`, or the fused path's table);
    z is philox_draw's normal draw on STREAM_ADAM at `dev`'s (seed, step),
    of global elements [elem0, elem0 + n), drawn only where nd != 0.
    Returns (theta, v_mom, m, v2)."""
    _check_vectors(g=g, theta=theta, theta0=theta0, v_mom=v_mom, m=m, v2=v2,
                   mask=mask, lr=lr)
    written = dict(v_mom=v_mom, m=m, v2=v2)
    read = dict(theta0=theta0, mask=mask, lr=lr)
    if sgd_step:
        written["theta"], read["g"] = theta, g
    elif add_g:
        written["g"], read["theta"] = g, theta
    else:
        read.update(g=g, theta=theta)
    _check_no_overlap(written, read)
    _check_dev(dev, g)
    _check_bc(bc, g)
    lib = _library("adam_sghmc_update")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.adam_sghmc_update(
            g.data_ptr(), theta.data_ptr(), theta0.data_ptr(),
            mask.data_ptr(), lr.data_ptr(), v_mom.data_ptr(), m.data_ptr(),
            v2.data_ptr(), g.numel(), check_offset(elem0, g.numel()),
            int(add_g) | int(sgd_step) << 1, _recip32(temperature),
            _recip32(prior_sig ** 2), _recip32(n_eff), _f32(nd), _f32(beta1),
            _f32(1.0 - beta1), _f32(beta2), _f32(1.0 - beta2), _f32(eps_adam),
            _f32(1.0 - alpha), _f32(2.0 * alpha), bc.data_ptr(),
            dev.data_ptr(), stream)
    _raise_on(err, "adam_sghmc_update")
    adam_sghmc_update.launches += 1
    return theta, v_mom, m, v2


adam_sghmc_update.launches = 0


def _draw_args(like, kind: str, stream: int):
    """philox_draw's output (a new fp32 vector shaped as `like`, on its
    card) and its kind and stream arguments, checked."""
    if not like.is_cuda:
        raise ValueError(f"like: kernel needs a CUDA tensor, got {like.device}")
    if like.dim() != 1:
        raise ValueError(f"like: kernel draws a 1-D vector, got "
                         f"{tuple(like.shape)}")
    if kind not in DRAW_KINDS:
        raise ValueError(f"kind: one of {sorted(DRAW_KINDS)}, got {kind!r}")
    if stream not in DRAW_STREAMS:
        raise ValueError(f"stream: one of {DRAW_STREAMS}, got {stream!r}")
    out = torch.empty(like.shape, dtype=torch.float32, device=like.device)
    _check_vectors(out=out)
    return out, DRAW_KINDS[kind], int(stream)


def philox_draw(like, dev, *, kind: str, stream: int, elem0: int = 0):
    """A new fp32 vector shaped as `like` on its card (csrc/philox_draw.cu):
    N(0, 1) (kind "normal") or U[0, 1) (kind "uniform") draws, a pure
    function of (seed, step, stream), the seed and the step read from `dev`
    (int64 [3], the last unused), `stream` one of DRAW_STREAMS: the
    elements [elem0, elem0 + n) of that draw of a longer vector."""
    out, k, sid = _draw_args(like, kind, stream)
    _check_dev(dev, out)
    lib = _library("philox_draw")
    with torch.cuda.device(out.device):
        err = lib.philox_draw(out.data_ptr(), out.numel(),
                              check_offset(elem0, out.numel()), k, sid,
                              dev.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "philox_draw")
    philox_draw.launches += 1
    return out


philox_draw.launches = 0


def noise_prefactor(nd: float, alpha: float, n_eff: float) -> float:
    """nd * sqrt(2 alpha) / N: the noise scale of csghmc_update at lr = 1."""
    return nd * math.sqrt(2.0 * alpha) / n_eff
