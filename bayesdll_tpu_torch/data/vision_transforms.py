"""Host-side image transforms (counterpart of
bayesdll_tpu.data.vision_transforms), numpy and PIL, mirroring the
reference's torchvision pipelines (reference `datasets.py:67-79`):

  train: RandomResizedCrop(224) + RandomHorizontalFlip + RandomRotation(30)
  eval:  Resize(256) + CenterCrop(224)
  both:  normalize with ImageNet stats (0.485/0.456/0.406, 0.229/0.224/0.225)

PIL is imported inside the functions that decode or resample, never at
import: the CIFAR path (`cifar_train_augment`) runs where PIL is absent.
The eval transform runs the native resize + crop + normalize
(`bayesdll_tpu_torch.native`) where it builds, PIL otherwise.
"""

from __future__ import annotations

import math

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_float(img_u8: np.ndarray) -> np.ndarray:
    x = img_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def load_image(path: str):
    from PIL import Image
    img = Image.open(path)
    return img.convert("RGB")


def random_resized_crop(img, size: int, rng: np.random.RandomState,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    """torchvision RandomResizedCrop semantics."""
    from PIL import Image
    w, h = img.size
    area = w * h
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = rng.randint(0, w - cw + 1)
            top = rng.randint(0, h - ch + 1)
            img = img.crop((left, top, left + cw, top + ch))
            return img.resize((size, size), Image.BILINEAR)
    # fallback: center crop
    return center_crop(resize_short(img, size), size)


def resize_short(img, size: int):
    from PIL import Image
    w, h = img.size
    if w < h:
        return img.resize((size, int(round(h * size / w))), Image.BILINEAR)
    return img.resize((int(round(w * size / h)), size), Image.BILINEAR)


def center_crop(img, size: int):
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def train_transform(img, rng: np.random.RandomState,
                    size: int = 224) -> np.ndarray:
    from PIL import Image
    img = random_resized_crop(img, size, rng)
    if rng.rand() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    angle = rng.uniform(-30, 30)
    img = img.rotate(angle, resample=Image.BILINEAR)
    return _to_float(np.asarray(img, np.uint8))


def eval_transform(img, size: int = 224,
                   use_native: bool = True) -> np.ndarray:
    if use_native:
        from bayesdll_tpu_torch import native
        if native.available():
            out = native.eval_preprocess(
                np.asarray(img, np.uint8), IMAGENET_MEAN, IMAGENET_STD,
                size=size, resize_to=int(size * 256 / 224))
            if out is not None:
                return out
    img = center_crop(resize_short(img, int(size * 256 / 224)), size)
    return _to_float(np.asarray(img, np.uint8))


def cifar_train_augment(x: np.ndarray, rng: np.random.RandomState,
                        pad: int = 4) -> np.ndarray:
    """Reference CIFAR train aug: RandomCrop(32, padding=4) + hflip
    (reference `datasets.py:180-186` conventions), vectorised over a batch
    of NHWC float images."""
    n, h, w, c = x.shape
    padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)),
                    mode="constant")
    out = np.empty_like(x)
    tops = rng.randint(0, 2 * pad + 1, size=n)
    lefts = rng.randint(0, 2 * pad + 1, size=n)
    flips = rng.rand(n) < 0.5
    for i in range(n):
        img = padded[i, tops[i]:tops[i] + h, lefts[i]:lefts[i] + w]
        out[i] = img[:, ::-1] if flips[i] else img
    return out
