"""Dataset files for the port's data tests, written from a numpy seed in
the layouts the readers take: CIFAR's pickle batches, the Pets annotation
files with JPEGs, and ImageNet's folder per class."""

import pickle
import time

import numpy as np
from PIL import Image

from bayesdll_tpu import native as jnative


def _dump(path, images, labels, label_key):
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({b"data": images.reshape(len(images), 3072),
                     label_key: [int(v) for v in labels]}, f)


def write_cifar(root, name, *, n_train, n_test, seed):
    """CIFAR-10 as five data batches and a test batch (b"labels"), or
    CIFAR-100 as train and test (b"fine_labels"): uint8 [N, 3072] rows,
    channel-major as in the published files."""
    rng = np.random.RandomState(seed)
    k = 10 if name == "cifar10" else 100
    xtr = rng.randint(0, 256, (n_train, 3, 32, 32)).astype(np.uint8)
    ytr = rng.randint(0, k, n_train)
    xte = rng.randint(0, 256, (n_test, 3, 32, 32)).astype(np.uint8)
    yte = rng.randint(0, k, n_test)
    if name == "cifar10":
        base = root / "cifar-10-batches-py"
        for i, (xs, ys) in enumerate(zip(np.array_split(xtr, 5),
                                         np.array_split(ytr, 5))):
            _dump(base / f"data_batch_{i + 1}", xs, ys, b"labels")
        _dump(base / "test_batch", xte, yte, b"labels")
    else:
        base = root / "cifar-100-python"
        _dump(base / "train", xtr, ytr, b"fine_labels")
        _dump(base / "test", xte, yte, b"fine_labels")


def _jpeg(path, rng, h, w):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8)).save(path)


def write_pets(root, *, n_trainval, n_test, seed):
    """oxford-iiit-pet/images/*.jpg with annotations/{trainval,test}.txt,
    three breeds, images of varying size."""
    base = root / "oxford-iiit-pet"
    rng = np.random.RandomState(seed)
    for split, n in (("trainval", n_trainval), ("test", n_test)):
        lines = []
        for i in range(n):
            name = f"Breed_{i % 3}_{split}_{i}"
            _jpeg(base / "images" / f"{name}.jpg", rng, 40 + 3 * i, 56)
            lines.append(f"{name} {i % 3 + 1} 1 1\n")
        (base / "annotations").mkdir(parents=True, exist_ok=True)
        (base / "annotations" / f"{split}.txt").write_text(
            "# Image CLASS-ID SPECIES BREED ID\n" + "".join(lines))


def write_imagenet(root, *, n_trainval, n_test, seed):
    """imagenet/{train,val}/<wnid>/*.JPEG, three classes."""
    base = root / "imagenet"
    rng = np.random.RandomState(seed)
    for split, n in (("train", n_trainval), ("val", n_test)):
        for i in range(n):
            _jpeg(base / split / f"n0{i % 3}" / f"img_{i}.JPEG", rng,
                  50, 36 + 4 * i)


def jax_native_ready(tries: int = 20) -> bool:
    """The JAX binding's library, loaded.  That binding compiles into its
    final path, so a worker that finds the file while another writes it
    fails to load it; it loads once the writer is done."""
    for _ in range(tries):
        if jnative.available():
            return True
        time.sleep(0.5)
    return False
