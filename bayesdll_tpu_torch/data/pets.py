"""Oxford-IIIT Pets (37 classes) from local files (counterpart of
bayesdll_tpu.data.pets; reference `datasets.py:58-116`).

Expected layout under data_root (the torchvision download layout):
  oxford-iiit-pet/images/*.jpg
  oxford-iiit-pet/annotations/trainval.txt
  oxford-iiit-pet/annotations/test.txt

Split semantics mirror the reference: official trainval re-split into
(train, val) by a seeded permutation, with val served through the eval
transform; official test used as-is (reference `datasets.py:81-96`).
"""

from __future__ import annotations

import os

NUM_CLASSES = 37


def _find_root(data_root: str):
    for cand in ("oxford-iiit-pet", "pets", "."):
        base = os.path.join(data_root, cand)
        if os.path.isdir(os.path.join(base, "images")) and \
                os.path.isdir(os.path.join(base, "annotations")):
            return base
    raise FileNotFoundError(
        f"Oxford-IIIT Pets not found under '{data_root}' (need "
        "oxford-iiit-pet/images + annotations; no network egress).")


def _read_split(base: str, fname: str):
    paths, labels = [], []
    with open(os.path.join(base, "annotations", fname)) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, class_id, *_ = line.split()
            paths.append(os.path.join(base, "images", name + ".jpg"))
            labels.append(int(class_id) - 1)  # 1-based in the annotations
    return paths, labels


def load_splits(data_root: str):
    """Returns ((trainval_paths, trainval_labels), (test_paths, test_labels))."""
    base = _find_root(data_root)
    return _read_split(base, "trainval.txt"), _read_split(base, "test.txt")
