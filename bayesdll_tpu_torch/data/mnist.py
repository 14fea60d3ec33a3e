"""MNIST from local IDX files (reference `datasets.py:8-56`).

Normalisation matches the reference's transform: ToTensor() scaling to [0,1]
then Normalize(mean=0.1307, std=0.3081).  Files are searched under
`data_root` in the standard layouts (`MNIST/raw/*-ubyte[.gz]` or flat).
No network egress is available, so missing files raise with guidance.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}

MEAN, STD = 0.1307, 0.3081


def _find(data_root: str, fname: str):
    for sub in ("", "MNIST/raw", "mnist", "MNIST"):
        for suffix in ("", ".gz"):
            p = os.path.join(data_root, sub, fname + suffix)
            if os.path.exists(p):
                return p
    return None


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    magic, = struct.unpack(">I", data[:4])
    ndim = magic & 0xFF
    dims = struct.unpack(">" + "I" * ndim, data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, np.uint8, offset=4 + 4 * ndim)
    return arr.reshape(dims)


def load(data_root: str):
    paths = {k: _find(data_root, v) for k, v in _FILES.items()}
    missing = [v for k, v in _FILES.items() if paths[k] is None]
    if missing:
        raise FileNotFoundError(
            f"MNIST files not found under '{data_root}' (missing: {missing}). "
            "This environment has no network egress — place the IDX files "
            "locally, or use dataset='synthetic'.")
    xtr = _read_idx(paths["train_images"]).astype(np.float32) / 255.0
    ytr = _read_idx(paths["train_labels"]).astype(np.int32)
    xte = _read_idx(paths["test_images"]).astype(np.float32) / 255.0
    yte = _read_idx(paths["test_labels"]).astype(np.int32)
    xtr = (xtr - MEAN) / STD
    xte = (xte - MEAN) / STD
    return (xtr[..., None], ytr), (xte[..., None], yte)
