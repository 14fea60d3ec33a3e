"""Data pipeline (counterpart of bayesdll_tpu.data, numpy only).

`prepare(cfg)` returns `(train_loader, val_loader, test_loader, nd)` with
nd the training-set size.  The train/val split is a seeded permutation of
the training set with a `val_heldout` fraction held out, as in the JAX
package, so both packages see the same examples in the same order.
Datasets load from local files only; `synthetic` needs none.
"""

from __future__ import annotations

import numpy as np

from bayesdll_tpu_torch.data import mnist as mnist_data
from bayesdll_tpu_torch.data.loader import ArrayLoader
from bayesdll_tpu_torch.data.synthetic import make_synthetic

__all__ = ["prepare", "ArrayLoader"]


def _split_train_val(x, y, val_heldout: float, seed: int):
    n = len(x)
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    n_val = int(n * val_heldout)
    if n_val == 0:
        return (x[perm], y[perm]), None
    val_idx, tr_idx = perm[:n_val], perm[n_val:]
    return (x[tr_idx], y[tr_idx]), (x[val_idx], y[val_idx])


def prepare(cfg):
    """Build loaders for cfg.dataset. Returns (train, val, test, nd)."""
    seed = cfg.seed
    if cfg.dataset == "synthetic":
        if cfg.backbone != "mlp_mnist":
            raise NotImplementedError(
                f"synthetic data for backbone '{cfg.backbone}' comes with "
                "that backbone's port (ROADMAP.md queue 1 item 11)")
        # at least 2 full train batches must survive the val split
        floor_n = int(np.ceil(2 * cfg.batch_size
                              / max(1e-9, 1.0 - cfg.val_heldout)))
        (xtr, ytr), (xte, yte), num_classes = make_synthetic(
            n_train=getattr(cfg, "synthetic_n_train", max(4096, floor_n)),
            n_test=getattr(cfg, "synthetic_n_test", 1024),
            input_shape=(784,),
            num_classes=cfg.num_classes,
            seed=seed,
        )
    elif cfg.dataset == "mnist":
        (xtr, ytr), (xte, yte) = mnist_data.load(cfg.data_root)
        num_classes = 10
        xtr = xtr.reshape(len(xtr), -1)
        xte = xte.reshape(len(xte), -1)
    else:
        raise NotImplementedError(
            f"dataset '{cfg.dataset}' is not ported yet (ROADMAP.md queue 1); "
            "ported: synthetic, mnist")

    cfg.num_classes = num_classes
    (xtr, ytr), val = _split_train_val(xtr, ytr, cfg.val_heldout, seed)
    train_loader = ArrayLoader(xtr, ytr, cfg.batch_size, shuffle=True,
                               seed=seed, drop_last=True)
    val_loader = (ArrayLoader(val[0], val[1], cfg.batch_size)
                  if val is not None else None)
    test_loader = ArrayLoader(xte, yte, cfg.batch_size)
    return train_loader, val_loader, test_loader, len(xtr)
