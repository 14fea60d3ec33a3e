"""The port's real-data loaders (CIFAR-10/100 pickles, Pets and ImageNet
JPEG folders) against the JAX package's on the same files and seed.

Fixtures are written under tmp_path from a numpy seed.  Every comparison
is bitwise: both packages run the same numpy and PIL code in the same
order, so the arrays (images, labels, `valid` masks) must be equal, per
epoch, per chain view and on the eval view.
"""

import numpy as np
import pytest
from PIL import Image

from bayesdll_tpu import native as jnative
from bayesdll_tpu.config import Config as JConfig
from bayesdll_tpu.data import cifar as jcifar
from bayesdll_tpu.data import prepare as jprepare
from bayesdll_tpu.data import vision_transforms as jvt
from bayesdll_tpu.data.image_loader import ImageFileLoader as JImageFileLoader
from bayesdll_tpu_torch import native
from bayesdll_tpu_torch.config import Config
from bayesdll_tpu_torch.data import cifar
from bayesdll_tpu_torch.data import prepare
from bayesdll_tpu_torch.data import vision_transforms as vt
from bayesdll_tpu_torch.data.image_loader import ImageFileLoader
from tests.torch_data_fixtures import (jax_native_ready, write_cifar,
                                       write_imagenet, write_pets)


def _assert_batches_equal(a_loader, b_loader):
    a, b = list(a_loader), list(b_loader)
    assert len(a) == len(b) > 0
    for (xa, ya, va), (xb, yb, vb) in zip(a, b):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(va, vb)


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_cifar_load_matches_jax(tmp_path, name):
    write_cifar(tmp_path, name, n_train=60, n_test=25, seed=0)
    (xtr, ytr), (xte, yte) = cifar.load(str(tmp_path), name)
    (jxtr, jytr), (jxte, jyte) = jcifar.load(str(tmp_path), name)
    assert xtr.shape == (60, 32, 32, 3) and xte.shape == (25, 32, 32, 3)
    assert xtr.dtype == np.float32 and ytr.dtype == np.int32
    for a, b in ((xtr, jxtr), (ytr, jytr), (xte, jxte), (yte, jyte)):
        np.testing.assert_array_equal(a, b)


def test_cifar_missing_files_raise(tmp_path):
    for name in ("cifar10", "cifar100"):
        with pytest.raises(FileNotFoundError, match="no network egress"):
            cifar.load(str(tmp_path), name)


@pytest.mark.parametrize("seed", [0, 1])
def test_cifar_train_augment_matches_jax(seed):
    x = np.random.RandomState(seed).randn(16, 32, 32, 3).astype(np.float32)
    out = vt.cifar_train_augment(x, np.random.RandomState(seed + 10))
    ref = jvt.cifar_train_augment(x, np.random.RandomState(seed + 10))
    np.testing.assert_array_equal(out, ref)
    assert out.shape == x.shape
    # the crop and flip move most images
    assert (np.abs(out - x).reshape(16, -1).max(axis=1) > 1e-6).sum() >= 12


@pytest.mark.parametrize("name", ["cifar10", "cifar100"])
def test_prepare_cifar_batches_match_jax(tmp_path, name):
    """train (augmented), val and test, two epochs each; chain_view(c, e)
    for c, e in {0, 1}; eval_view of the train loader."""
    write_cifar(tmp_path, name, n_train=100, n_test=30, seed=1)
    kw = dict(dataset=name, backbone="resnet50", batch_size=16, seed=3,
              data_root=str(tmp_path), val_heldout=0.2)
    tl, vl, sl, nd = prepare(Config(device="cpu", **kw))
    jl, jvl, jsl, jnd = jprepare(JConfig(**kw))
    assert nd == jnd == 80
    assert tl.augment_fn is vt.cifar_train_augment
    for _epoch in range(2):  # the loaders' own RandomState runs on
        _assert_batches_equal(tl, jl)
        _assert_batches_equal(vl, jvl)
        _assert_batches_equal(sl, jsl)
    for c in (0, 1):
        for e in (0, 1):
            _assert_batches_equal(tl.chain_view(c, e), jl.chain_view(c, e))
    ev = tl.eval_view()
    assert ev.augment_fn is None
    _assert_batches_equal(ev, jl.eval_view())
    # the train batches are augmented: none equals its un-augmented copy
    x_aug = next(iter(tl.chain_view(0, 0)))[0]
    x_raw = next(iter(tl.chain_view(0, 0).eval_view()))[0]
    assert not np.array_equal(x_aug, x_raw)
    # the test set's final batch is padded: 30 = 16 + 14
    assert list(sl)[-1][2].sum() == 14


@pytest.fixture(params=["pil", "native"])
def decode_path(request, monkeypatch):
    """The eval transform's resize: PIL in both packages, or each package's
    native library (where both build)."""
    if request.param == "pil":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    else:
        if not (native.available() and jax_native_ready()):
            pytest.skip("a native library did not build (no compiler?)")
    return request.param


@pytest.mark.parametrize("dataset", ["pets", "imagenet"])
def test_image_loader_batches_match_jax(tmp_path, dataset, decode_path):
    """ImageFileLoader, train (crop, flip, rotation per image) and eval
    (resize, centre crop), bitwise; two epochs, two chain views, and the
    padded final eval batch."""
    from bayesdll_tpu.data import imagenet as jimagenet
    from bayesdll_tpu.data import pets as jpets
    from bayesdll_tpu_torch.data import imagenet, pets
    write = write_pets if dataset == "pets" else write_imagenet
    write(tmp_path, n_trainval=10, n_test=7, seed=2)
    mod, jmod = (pets, jpets) if dataset == "pets" else (imagenet, jimagenet)
    (tv, tvy), (te, tey) = mod.load_splits(str(tmp_path))
    assert ((tv, tvy), (te, tey)) == jmod.load_splits(str(tmp_path))
    kw = dict(size=48, num_threads=3)
    train = ImageFileLoader(tv, tvy, 4, train=True, seed=5, **kw)
    jtrain = JImageFileLoader(tv, tvy, 4, train=True, seed=5, **kw)
    for _epoch in range(2):
        _assert_batches_equal(train, jtrain)
    for c in (0, 1):
        _assert_batches_equal(train.chain_view(c, 1), jtrain.chain_view(c, 1))
    test = ImageFileLoader(te, tey, 4, train=False, **kw)
    _assert_batches_equal(test, JImageFileLoader(te, tey, 4, train=False,
                                                 **kw))
    _assert_batches_equal(train.eval_view(), jtrain.eval_view())
    batches = list(test)
    assert len(batches) == 2 and batches[-1][2].sum() == 3
    assert batches[-1][0].shape == (4, 48, 48, 3)


@pytest.mark.parametrize("dataset", ["pets", "imagenet"])
def test_prepare_image_folder_matches_jax(tmp_path, dataset):
    write = write_pets if dataset == "pets" else write_imagenet
    write(tmp_path, n_trainval=10, n_test=5, seed=4)
    kw = dict(dataset=dataset, backbone="resnet101", batch_size=4, seed=1,
              data_root=str(tmp_path), val_heldout=0.2)
    cfg, jcfg = Config(device="cpu", **kw), JConfig(**kw)
    tl, vl, sl, nd = prepare(cfg)
    jl, jvl, jsl, jnd = jprepare(jcfg)
    assert nd == jnd == 8
    assert cfg.num_classes == jcfg.num_classes == \
        (37 if dataset == "pets" else 1000)
    for a, b in ((tl, jl), (vl, jvl), (sl, jsl)):
        assert a.paths == b.paths
        np.testing.assert_array_equal(a.labels, b.labels)
    x, y, valid = next(iter(tl))
    np.testing.assert_array_equal(x, next(iter(jl))[0])
    assert x.shape == (4, 224, 224, 3) and x.dtype == np.float32


def test_eval_transform_matches_jax_with_native_and_pil():
    rng = np.random.RandomState(3)
    img = Image.fromarray(rng.randint(0, 256, (100, 130, 3), np.uint8))
    for use_native in (False, True):
        np.testing.assert_array_equal(
            vt.eval_transform(img, 64, use_native=use_native),
            jvt.eval_transform(img, 64, use_native=use_native))
    out = vt.train_transform(img, np.random.RandomState(0), 64)
    np.testing.assert_array_equal(
        out, jvt.train_transform(img, np.random.RandomState(0), 64))
    assert out.shape == (64, 64, 3) and out.dtype == np.float32


def test_unknown_dataset_raises():
    with pytest.raises(NotImplementedError, match="local files"):
        prepare(Config(dataset="svhn", device="cpu"))
