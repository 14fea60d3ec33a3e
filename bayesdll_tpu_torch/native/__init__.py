"""ctypes binding of the native preprocessing library (counterpart of
bayesdll_tpu.native).

`preprocess.cc` (a copy of the JAX package's) compiles with
`g++ -O3 -march=native -shared -fPIC` at first use into
`build/native/` at the repository root, never beside this file; the file
name carries a hash of the source and the flags.  The compiler writes a
name of its own process, which `os.replace` then moves into place, so
several processes building at once never load a half-written library;
within a process a lock lets one thread build while the others wait (the
image loader's threads reach it together).
`available()` is False where no compiler works; the eval transform then
resamples with PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "preprocess.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lib = None
_failed = False  # a build that failed is not tried again in this process
_lock = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libbdltpu_torch-{h.hexdigest()[:16]}.so"


def _try_build(out: Path) -> bool:
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load():
    if _lib is not None or _failed:
        return _lib
    with _lock:
        return _load_locked()


def _load_locked():
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    so = library_path()
    if not so.exists() and not _try_build(so):
        _failed = True
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        _failed = True
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.resize_bilinear_u8.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                       u8p, ctypes.c_int, ctypes.c_int]
    lib.resize_bilinear_u8.restype = None
    lib.crop_flip_normalize.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32p, f32p, f32p]
    lib.crop_flip_normalize.restype = None
    lib.eval_preprocess.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, u8p, f32p]
    lib.eval_preprocess.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _rgb_u8(img_u8) -> np.ndarray:
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    if img_u8.ndim != 3 or img_u8.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {img_u8.shape}")
    return img_u8


def _lround(x: float) -> int:
    """C's lround (halves away from zero), as preprocess.cc sizes its
    resize; Python's round() takes halves to even.  Never below lround."""
    return math.floor(x + 0.5)


def resize_bilinear(img_u8: np.ndarray, dh: int, dw: int) -> np.ndarray:
    lib = _load()
    img_u8 = _rgb_u8(img_u8)
    out = np.empty((dh, dw, 3), np.uint8)
    lib.resize_bilinear_u8(_u8p(img_u8), img_u8.shape[0], img_u8.shape[1],
                           _u8p(out), dh, dw)
    return out


def crop_flip_normalize(img_u8: np.ndarray, top: int, left: int, size: int,
                        flip: bool, mean: np.ndarray,
                        std: np.ndarray) -> np.ndarray:
    """A size x size window at (top, left), mirrored if `flip`, as float32
    (x / 255 - mean) / std."""
    lib = _load()
    img_u8 = _rgb_u8(img_u8)
    sh, sw = img_u8.shape[:2]
    if not (0 <= top <= sh - size and 0 <= left <= sw - size):
        raise ValueError(f"window {size} at ({top}, {left}) outside "
                         f"{sh}x{sw}")
    out = np.empty((size, size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.crop_flip_normalize(_u8p(img_u8), sh, sw, top, left, size, int(flip),
                            _f32p(mean), _f32p(std), _f32p(out))
    return out


def eval_preprocess(img_u8: np.ndarray, mean: np.ndarray, std: np.ndarray,
                    size: int = 224, resize_to: int = 256):
    """Fused resize-short-side + center-crop + normalize.  Returns float32
    [size, size, 3] or None if the image is too small (caller falls back)."""
    lib = _load()
    img_u8 = _rgb_u8(img_u8)
    sh, sw = img_u8.shape[0], img_u8.shape[1]
    # the resized image's size as preprocess.cc computes it, so the scratch
    # holds what it writes
    if sw < sh:
        rh = _lround(sh * resize_to / sw); rw = resize_to
    else:
        rw = _lround(sw * resize_to / sh); rh = resize_to
    scratch = np.empty((rh * rw * 3,), np.uint8)
    out = np.empty((size, size, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    rc = lib.eval_preprocess(_u8p(img_u8), sh, sw, resize_to, size,
                             _f32p(mean), _f32p(std), _u8p(scratch),
                             _f32p(out))
    return out if rc == 0 else None
