"""SwinV2's window attention: per window and head

    o = softmax(q k^T + bias[h] + mask[w]) v,

with q, k, v [B, W, H, N, d] (batch, windows, heads, tokens of a window,
head width; any strides with the last one 1), the bias [H, N, N] shared by
the batch and the windows, and the shift mask given by each window's
region labels [W, N] (int32): -100 between tokens of different regions,
0 within one; `regions=None` for a block without a mask.

`window_attention` is what models/swinv2.py calls.  On CPU tensors it runs
`window_attention_plain`, plain PyTorch in fp32 (differentiable by
autograd, and vmappable for Laplace's per-example Fisher).  On CUDA
tensors it runs the hand-written CUDA kernels of csrc/window_attention.cu
(built and loaded as ops/kernels.py builds the update kernels) through
`WindowAttention`, an autograd Function: the forward writes o and each
row's log-sum-exp, the backward dq, dk, dv, and the bias gradient
dBias[h] = sum over the batch and the windows of dS, accumulated in fp32
inside the kernel and returned in the bias's dtype.  No [B, ..., N, N]
tensor reaches device memory.  The kernels read the bias in q's dtype
(bf16 in the benchmark's SwinV2, as SDPA read it before) and add it, and
the mask, to each score in fp32.  There is no fallback: a CUDA call the
kernels do not take (a head width other than 16 or 32, an N that is not
a multiple of 8, another
dtype than fp16, bf16 or fp32, or a call under torch.func transforms)
raises.

Launches are counted by kernel name (`launch_counts`, merged into
ops/kernels.py::launch_counts).
"""

from __future__ import annotations

import ctypes
import functools

import torch

MASK_VALUE = -100.0
LOG2E = 1.4426950408889634
KERNELS = ("window_attn_fwd", "window_attn_bwd_dq", "window_attn_bwd_dkdv",
           "window_attn_dbias")
DTYPES = (torch.float16, torch.bfloat16, torch.float32)
HEAD_WIDTHS = (16, 32)
LIBRARY = "window_attention"  # csrc/window_attention.cu

_launches = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict:
    return dict(_launches)


def set_launch_counts(counts: dict):
    for name, n in counts.items():
        if name in _launches:
            _launches[name] = n


def region_mask(regions: torch.Tensor) -> torch.Tensor:
    """[W, N] labels -> the [W, N, N] fp32 shift mask."""
    same = regions[:, :, None] == regions[:, None, :]
    return torch.where(same, 0.0, MASK_VALUE)


def window_attention_plain(q, k, v, bias, regions=None):
    """The formula in fp32 torch ops; o in q's dtype."""
    s = q.float() @ k.float().transpose(-1, -2) + bias.float()
    if regions is not None:
        s = s + region_mask(regions)[:, None]
    return (torch.softmax(s, -1) @ v.float()).to(q.dtype)


def _check(q, k, v, bias, regions):
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"window_attention takes q, k, v [B, W, H, N, d] "
                         f"of one shape, not {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _, w, h, n, _ = q.shape
    if bias.shape != (h, n, n):
        raise ValueError(f"the bias is [H, N, N] = {(h, n, n)}, not "
                         f"{tuple(bias.shape)}")
    if regions is not None and (regions.shape != (w, n)
                                or regions.dtype != torch.int32):
        raise ValueError(f"the regions are [W, N] = {(w, n)} int32, not "
                         f"{tuple(regions.shape)} {regions.dtype}")
    if len({t.device for t in (q, k, v, bias)}
           | ({regions.device} if regions is not None else set())) != 1:
        raise ValueError("window_attention's tensors lie on several devices")


def window_attention(q, k, v, bias, regions=None):
    """o [B, W, H, N, d] in q's dtype; see the module's docstring."""
    _check(q, k, v, bias, regions)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, regions)
    if not q.is_cuda:
        raise ValueError(f"window_attention runs on CPU or CUDA tensors, "
                         f"not {q.device}")
    if torch._C._are_functorch_transforms_active():
        raise RuntimeError("window_attention's CUDA kernels do not run "
                           "under torch.func transforms (vmap, grad)")
    if q.dtype not in DTYPES or {k.dtype, v.dtype} != {q.dtype} \
            or not bias.is_floating_point():
        raise ValueError(f"window_attention's kernels take q, k, v in one "
                         f"of {DTYPES} and a floating bias, not {q.dtype}, "
                         f"{k.dtype}, {v.dtype}, {bias.dtype}")
    if q.shape[-1] not in HEAD_WIDTHS:
        raise ValueError(f"window_attention's kernels take head widths "
                         f"{HEAD_WIDTHS}, not {q.shape[-1]}")
    if q.shape[3] % 8:
        raise ValueError(f"window_attention's kernels take an N that is a "
                         f"multiple of 8, not {q.shape[3]}")
    return WindowAttention.apply(q, k, v, bias, regions)


class _Params(ctypes.Structure):
    """csrc/window_attention.cu's Params: pointers, element strides
    (batch, window, head, row) and the sizes."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "q", "k", "v", "bias", "lab", "o", "dout", "out0", "out1", "lse",
        "delta", "dbias")]
        + [(name, ctypes.c_int64 * 4) for name in (
            "sq", "sk", "sv", "so", "sdo", "s0", "s1")]
        + [(name, ctypes.c_int) for name in ("B", "W", "H", "N")])


_DTYPE_IDS = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}


@functools.cache
def _library() -> ctypes.CDLL:
    from bayesdll_tpu_torch.ops import kernels
    kernels.build((LIBRARY,))
    lib = ctypes.CDLL(str(kernels.library_path(LIBRARY)))
    lib.window_attn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.window_attn.restype = ctypes.c_int
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, q, bias, lab, **tensors):
    """Launch kernel `name` over q's [B, W, H, N, d] with the bias (or
    its transpose), the labels (or None) and the other tensors by their
    Params field (the five-dimensional ones give their strides too)."""
    b, w, h, n, d = q.shape
    p = _Params(q=q.data_ptr(), bias=bias.data_ptr(), lab=_ptr(lab),
                B=b, W=w, H=h, N=n)
    p.sq[:] = q.stride()[:4]
    strides = {"k": "sk", "v": "sv", "o": "so", "dout": "sdo", "out0": "s0",
               "out1": "s1"}
    for field, t in tensors.items():
        setattr(p, field, t.data_ptr())
        if field in strides:
            getattr(p, strides[field])[:] = t.stride()[:4]
    with torch.cuda.device(q.device):
        err = _library().window_attn(
            KERNELS.index(name), _DTYPE_IDS[q.dtype], d, ctypes.byref(p),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    _launches[name] += 1


def _aligned(t):
    """t, or a copy of it, with rows of stride 1, a 16-byte aligned start
    and strides of whole 16 bytes (the kernels' 16-byte cp.async copies)."""
    size = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _rows_like(q):
    """An empty [B, W, H, N, d] tensor laid out [B, W, N, H, d], the
    layout the output projection reads."""
    b, w, h, n, d = q.shape
    return q.new_empty(b, w, n, h, d).transpose(2, 3)


class WindowAttention(torch.autograd.Function):
    """The kernels' forward and backward (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, regions):
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        b, w, h, n, _ = q.shape
        bias_k = _aligned(bias.detach().to(q.dtype).contiguous())
        lab = None if regions is None else _aligned(regions.contiguous())
        o = _rows_like(q)
        lse = torch.empty(b, w, h, n, dtype=torch.float32, device=q.device)
        _launch("window_attn_fwd", q, bias_k, lab, k=k, v=v, out0=o,
                lse=lse)
        ctx.save_for_backward(q, k, v, bias_k, lab, o, lse)
        ctx.bias_dtype = bias.dtype
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias_k, lab, o, lse = ctx.saved_tensors
        do = _aligned(do)
        _, _, h, n, _ = q.shape
        delta = torch.empty_like(lse)
        dq, dk, dv = _rows_like(q), _rows_like(q), _rows_like(q)
        dbias = torch.empty(h, n, n, dtype=torch.float32, device=q.device)
        common = dict(k=k, v=v, dout=do, lse=lse, delta=delta)
        _launch("window_attn_bwd_dq", q, bias_k, lab, o=o, out0=dq,
                **common)
        _launch("window_attn_bwd_dkdv", q,
                bias_k.transpose(1, 2).contiguous(), lab, out0=dk, out1=dv,
                **common)
        _launch("window_attn_dbias", q, bias_k, lab, dbias=dbias, **common)
        return dq, dk, dv, dbias.to(ctx.bias_dtype), None
