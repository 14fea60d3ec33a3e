"""CIFAR-10/100 from local python-pickle batches (counterpart of
bayesdll_tpu.data.cifar; reference `datasets.py:173-279`).

Normalisation matches the reference transforms:
  CIFAR-10:  mean (0.4914, 0.4822, 0.4465), std (0.2470, 0.2435, 0.2616)
  CIFAR-100: mean (0.5071, 0.4865, 0.4409), std (0.2673, 0.2564, 0.2762)
Train-time augmentation (random crop + flip) is applied by the loader's
owner if desired; the base arrays here are the un-augmented images (NHWC).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

_STATS = {
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)),
    "cifar100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
}


def _load_batch(path, label_key):
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.asarray(d[label_key], np.int32)
    return x, y


def load(data_root: str, name: str = "cifar10"):
    if name == "cifar10":
        base = None
        for cand in ("cifar-10-batches-py", "cifar10"):
            p = os.path.join(data_root, cand)
            if os.path.isdir(p):
                base = p
                break
        if base is None:
            raise FileNotFoundError(
                f"CIFAR-10 batches not found under '{data_root}' "
                "(no network egress; place cifar-10-batches-py locally).")
        xs, ys = [], []
        for i in range(1, 6):
            x, y = _load_batch(os.path.join(base, f"data_batch_{i}"), b"labels")
            xs.append(x); ys.append(y)
        xtr, ytr = np.concatenate(xs), np.concatenate(ys)
        xte, yte = _load_batch(os.path.join(base, "test_batch"), b"labels")
    else:
        base = os.path.join(data_root, "cifar-100-python")
        if not os.path.isdir(base):
            raise FileNotFoundError(
                f"CIFAR-100 not found under '{data_root}' "
                "(no network egress; place cifar-100-python locally).")
        xtr, ytr = _load_batch(os.path.join(base, "train"), b"fine_labels")
        xte, yte = _load_batch(os.path.join(base, "test"), b"fine_labels")

    mean, std = _STATS[name]
    mean = np.asarray(mean, np.float32).reshape(1, 1, 1, 3)
    std = np.asarray(std, np.float32).reshape(1, 1, 1, 3)
    xtr = (xtr.astype(np.float32) / 255.0 - mean) / std
    xte = (xte.astype(np.float32) / 255.0 - mean) / std
    return (xtr, ytr), (xte, yte)
