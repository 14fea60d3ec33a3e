"""ImageNet from a local folder-per-class layout (counterpart of
bayesdll_tpu.data.imagenet; reference `datasets.py:118-171`).

Expected layout under data_root:
  imagenet/train/<wnid>/*.JPEG
  imagenet/val/<wnid>/*.JPEG
"""

from __future__ import annotations

import os

NUM_CLASSES = 1000


def _find_root(data_root: str):
    for cand in ("imagenet", "ImageNet", "ILSVRC2012", "."):
        base = os.path.join(data_root, cand)
        if os.path.isdir(os.path.join(base, "train")):
            return base
    raise FileNotFoundError(
        f"ImageNet not found under '{data_root}' (need train/<wnid>/ "
        "layout; no network egress).")


def _scan(split_dir: str):
    classes = sorted(d for d in os.listdir(split_dir)
                     if os.path.isdir(os.path.join(split_dir, d)))
    class_to_idx = {c: i for i, c in enumerate(classes)}
    paths, labels = [], []
    for c in classes:
        d = os.path.join(split_dir, c)
        for fname in sorted(os.listdir(d)):
            if fname.lower().endswith((".jpeg", ".jpg", ".png")):
                paths.append(os.path.join(d, fname))
                labels.append(class_to_idx[c])
    return paths, labels, classes


def load_splits(data_root: str):
    base = _find_root(data_root)
    train = _scan(os.path.join(base, "train"))
    val_dir = os.path.join(base, "val")
    val = _scan(val_dir) if os.path.isdir(val_dir) else ([], [], [])
    return (train[0], train[1]), (val[0], val[1])
