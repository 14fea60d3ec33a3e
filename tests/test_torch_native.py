"""The port's native preprocessing binding (bayesdll_tpu_torch.native)
against the JAX package's binding of the same source, bitwise; where it
builds its library; and the eval transform's fall back to PIL where no
compiler works."""

import subprocess
import sys
import threading

import numpy as np
import pytest
from PIL import Image

from bayesdll_tpu import native as jnative
from bayesdll_tpu_torch import native
from bayesdll_tpu_torch.data import vision_transforms as vt
from tests.torch_data_fixtures import jax_native_ready

MEAN, STD = vt.IMAGENET_MEAN, vt.IMAGENET_STD


@pytest.fixture(scope="module")
def libs_ok():
    if not (native.available() and jax_native_ready()):
        pytest.skip("a native library did not build (no compiler?)")
    return True


def _img(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("src,dst", [((120, 160), (60, 80)),
                                     ((37, 53), (90, 41)),
                                     ((375, 500), (256, 341))])
def test_resize_bilinear_matches_jax_binding(libs_ok, src, dst):
    img = _img(0, *src)
    out = native.resize_bilinear(img, *dst)
    assert out.shape == dst + (3,) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, jnative.resize_bilinear(img, *dst))


@pytest.mark.parametrize("shape,size", [((300, 280), 224), ((375, 500), 224),
                                        ((90, 70), 48)])
def test_eval_preprocess_matches_jax_binding(libs_ok, shape, size):
    img = _img(1, *shape)
    kw = dict(size=size, resize_to=int(size * 256 / 224))
    out = native.eval_preprocess(img, MEAN, STD, **kw)
    assert out.shape == (size, size, 3) and out.dtype == np.float32
    np.testing.assert_array_equal(out, jnative.eval_preprocess(img, MEAN, STD,
                                                               **kw))


@pytest.mark.parametrize("flip", [0, 1])
def test_crop_flip_normalize_matches_jax_binding(libs_ok, flip):
    img = _img(2, 64, 64)
    out = native.crop_flip_normalize(img, 10, 5, 32, flip, MEAN, STD)
    ref = np.empty((32, 32, 3), np.float32)
    jnative._load().crop_flip_normalize(
        jnative._u8p(img), 64, 64, 10, 5, 32, flip, jnative._f32p(MEAN),
        jnative._f32p(STD), jnative._f32p(ref))
    np.testing.assert_array_equal(out, ref)
    expect = img[10:42, 5:37].astype(np.float32) / 255.0
    if flip:
        expect = expect[:, ::-1]
    np.testing.assert_allclose(out, (expect - MEAN) / STD, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="outside"):
        native.crop_flip_normalize(img, 40, 0, 32, flip, MEAN, STD)


def test_resize_close_to_pil(libs_ok):
    img = _img(0, 120, 160)
    out = native.resize_bilinear(img, 60, 80)
    pil = np.asarray(Image.fromarray(img).resize((80, 60), Image.BILINEAR),
                     np.uint8)
    diff = np.abs(out.astype(int) - pil.astype(int))
    assert diff.max() <= 1 and diff.mean() < 0.5


def test_eval_preprocess_sizes_its_scratch_as_the_library(libs_ok):
    """A 512 x 513 image resizes to 256 x 256.5: preprocess.cc rounds the
    half up (lround, 257 columns), Python's round() to even (256).  The
    scratch holds the 257 columns the library writes, and the result is
    the library's resize, cropped and normalised."""
    assert native._lround(513 * 256 / 512) == 257 != round(513 * 256 / 512)
    img = _img(4, 512, 513)
    out = native.eval_preprocess(img, MEAN, STD)
    resized = native.resize_bilinear(img, 256, 257)
    ref = native.crop_flip_normalize(resized, 16, 16, 224, False, MEAN, STD)
    np.testing.assert_array_equal(out, ref)
    # a short side resized below the crop: the caller falls back to PIL
    assert native.eval_preprocess(img, MEAN, STD, size=224,
                                  resize_to=200) is None


def test_eval_transform_uses_native_when_available(libs_ok):
    img = _img(3, 256, 300)
    out = vt.eval_transform(Image.fromarray(img))
    np.testing.assert_array_equal(out, native.eval_preprocess(img, MEAN, STD))
    pil = vt.eval_transform(Image.fromarray(img), use_native=False)
    assert np.abs(out - pil).mean() < 0.15  # normalised units


def test_library_is_built_under_build_native(libs_ok):
    from pathlib import Path
    root = Path(native.__file__).resolve().parents[2]
    so = native.library_path()
    assert so.parent == root / "build" / "native" and so.exists()
    assert not list((root / "bayesdll_tpu_torch").rglob("*.so"))


def test_concurrent_first_builds_load_one_whole_library(tmp_path,
                                                        monkeypatch):
    """Threads of two processes build into an empty directory at once: each
    loads a whole library, and no temporary file is left."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    code = ("import sys; from pathlib import Path; "
            "from bayesdll_tpu_torch import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); "
            "print(native.available())")
    other = subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                             stdout=subprocess.PIPE, text=True)
    results = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(
            target=lambda: results.append(native.available()))
            for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    out, _ = other.communicate(timeout=120)
    if not all(results):
        pytest.skip("no compiler here")
    assert results == [True] * 12 and out.strip() == "True"
    assert [p.name for p in tmp_path.iterdir()] == [native.library_path().name]
    img = _img(6, 40, 50)
    pil = np.asarray(Image.fromarray(img).resize((25, 20), Image.BILINEAR))
    assert np.abs(native.resize_bilinear(img, 20, 25).astype(int)
                  - pil.astype(int)).max() <= 1


def test_no_compiler_falls_back_to_pil(tmp_path, monkeypatch):
    """With no g++ on the PATH the library is not available, and the eval
    transform gives PIL's result."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", False)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert not native.available()
    assert list(tmp_path.iterdir()) == []
    img = Image.fromarray(_img(7, 90, 110))
    np.testing.assert_array_equal(vt.eval_transform(img, 64),
                                  vt.eval_transform(img, 64, use_native=False))
