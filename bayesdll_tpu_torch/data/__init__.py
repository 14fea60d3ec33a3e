"""Data pipeline (counterpart of bayesdll_tpu.data, numpy only).

`prepare(cfg)` returns `(train_loader, val_loader, test_loader, nd)` with
nd the training-set size.  The train/val split is a seeded permutation of
the training set with a `val_heldout` fraction held out, as in the JAX
package, so both packages see the same examples in the same order.
Datasets load from local files under `cfg.data_root` only (mnist,
cifar10, cifar100, pets, imagenet); `synthetic` needs none.  CIFAR's train
loader crops and flips each batch (`cifar_train_augment`); Pets and ImageNet
decode their files on the host in `ImageFileLoader`'s threads.
"""

from __future__ import annotations

import numpy as np

from bayesdll_tpu_torch.data import cifar as cifar_data
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
        # the backbone's input shape; at more than 10,000 values per example
        # the set is smaller, by the JAX package's rule, so that both
        # packages see the same arrays
        from bayesdll_tpu_torch.models import create_backbone
        _, in_shape, _ = create_backbone(cfg.backbone,
                                         num_classes=cfg.num_classes)
        big = int(np.prod(in_shape)) > 10_000
        # at least 2 full train batches must survive the val split
        floor_n = int(np.ceil(2 * cfg.batch_size
                              / max(1e-9, 1.0 - cfg.val_heldout)))
        (xtr, ytr), (xte, yte), num_classes = make_synthetic(
            n_train=getattr(cfg, "synthetic_n_train",
                            max(512 if big else 4096, floor_n)),
            n_test=getattr(cfg, "synthetic_n_test", 256 if big else 1024),
            input_shape=in_shape,
            num_classes=cfg.num_classes,
            seed=seed,
        )
    elif cfg.dataset == "mnist":
        (xtr, ytr), (xte, yte) = mnist_data.load(cfg.data_root)
        num_classes = 10
        if cfg.backbone == "mlp_mnist":
            xtr = xtr.reshape(len(xtr), -1)
            xte = xte.reshape(len(xte), -1)
    elif cfg.dataset in ("cifar10", "cifar100"):
        (xtr, ytr), (xte, yte) = cifar_data.load(cfg.data_root, cfg.dataset)
        num_classes = 10 if cfg.dataset == "cifar10" else 100
    elif cfg.dataset in ("pets", "imagenet"):
        return _prepare_image_folder(cfg)
    else:
        raise NotImplementedError(
            f"dataset '{cfg.dataset}' (the reference supports mnist/pets/"
            f"imagenet/cifar10/cifar100, from local files; and synthetic)")

    cfg.num_classes = num_classes
    (xtr, ytr), val = _split_train_val(xtr, ytr, cfg.val_heldout, seed)

    augment = None
    if cfg.dataset in ("cifar10", "cifar100"):
        # reference CIFAR train aug: RandomCrop(32, pad 4) + hflip
        from bayesdll_tpu_torch.data.vision_transforms import \
            cifar_train_augment
        augment = cifar_train_augment

    train_loader = ArrayLoader(xtr, ytr, cfg.batch_size, shuffle=True,
                               seed=seed, drop_last=True, augment_fn=augment)
    val_loader = (ArrayLoader(val[0], val[1], cfg.batch_size)
                  if val is not None else None)
    test_loader = ArrayLoader(xte, yte, cfg.batch_size)
    return train_loader, val_loader, test_loader, len(xtr)


def _prepare_image_folder(cfg):
    """Pets / ImageNet: file-backed loaders with train-time augmentation
    (reference `datasets.py:58-171`).  The official trainval split is
    re-split into (train, val) by a seeded permutation, with val served
    through eval transforms (reference `datasets.py:81-96`)."""
    from bayesdll_tpu_torch.data.image_loader import ImageFileLoader

    if cfg.dataset == "pets":
        from bayesdll_tpu_torch.data import pets as ds
    else:
        from bayesdll_tpu_torch.data import imagenet as ds
    (tv_paths, tv_labels), (te_paths, te_labels) = ds.load_splits(cfg.data_root)
    cfg.num_classes = ds.NUM_CLASSES

    tv_paths = np.asarray(tv_paths)
    tv_labels = np.asarray(tv_labels, np.int32)
    n = len(tv_paths)
    rng = np.random.RandomState(cfg.seed)
    perm = rng.permutation(n)
    n_val = int(n * cfg.val_heldout)
    val_idx, tr_idx = perm[:n_val], perm[n_val:]

    train_loader = ImageFileLoader(tv_paths[tr_idx], tv_labels[tr_idx],
                                   cfg.batch_size, train=True, seed=cfg.seed)
    val_loader = ImageFileLoader(tv_paths[val_idx], tv_labels[val_idx],
                                 cfg.batch_size, train=False) \
        if n_val > 0 else None
    test_loader = ImageFileLoader(te_paths, te_labels, cfg.batch_size,
                                  train=False)
    return train_loader, val_loader, test_loader, len(tr_idx)
