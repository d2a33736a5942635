"""The port's binding of the native LANCZOS resampler
(footprints_tpu_torch/native) on the CPU: byte for byte equal to PIL and to
the JAX package's binding of the same source (footprints_tpu/native), the
KITTI dataset's samples equal with and without FOOTPRINTS_NATIVE_RESIZE,
and a raise, not a PIL fallback, when the library cannot be built."""

import os
import shutil

import numpy as np
import pytest
from PIL import Image

from footprints_tpu import native as jax_native
from footprints_tpu_torch import native
from footprints_tpu_torch.core.config import load_config, readlines
from footprints_tpu_torch.data import DataLoader, KITTIDataset

from .test_trainer_e2e import _make_kitti_tree

SHAPES = [
    (375, 1242, 192, 640),   # KITTI
    (512, 640, 256, 448),    # handheld downscale
    (100, 80, 192, 640),     # upscale
    (33, 47, 16, 24),        # odd sizes
]


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not available")
    return native.load_library()


def _image(shape, seed):
    return np.random.RandomState(seed).randint(0, 256, shape, np.uint8)


def test_library_builds_outside_native(lib):
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "footprints_tpu_torch"


@pytest.mark.parametrize("sh,sw,dh,dw", SHAPES)
def test_lanczos_equals_pil_and_the_jax_binding(lib, sh, sw, dh, dw):
    img = _image((sh, sw, 3), seed=sh)
    got = native.resize_lanczos(img, dh, dw)
    ref = np.asarray(Image.fromarray(img).resize((dw, dh), Image.LANCZOS))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jax_native.resize_lanczos(img, dh, dw))


@pytest.mark.parametrize("sh,sw,dh,dw", SHAPES)
def test_lanczos_f32_equals_pil_and_the_jax_binding(lib, sh, sw, dh, dw):
    img = _image((sh, sw, 3), seed=sh + 1)
    got = native.resize_lanczos_f32(img, dh, dw)
    ref = np.asarray(Image.fromarray(img).resize((dw, dh), Image.LANCZOS),
                     np.float32) / 255.0
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_array_equal(got, jax_native.resize_lanczos_f32(img, dh, dw))


def test_grayscale_is_one_channel(lib):
    img = _image((50, 70), seed=2)
    got = native.resize_lanczos(img, 24, 32)
    assert got.shape == (24, 32, 1)
    ref = np.asarray(Image.fromarray(img).resize((32, 24), Image.LANCZOS))
    np.testing.assert_array_equal(got[..., 0], ref)


@pytest.mark.parametrize("sh,sw,dh,dw", [(37, 53, 16, 24), (16, 24, 37, 53)])
def test_nearest_f32_equals_cv2_and_the_jax_binding(lib, sh, sw, dh, dw):
    import cv2

    arr = np.random.RandomState(3).rand(sh, sw).astype(np.float32)
    got = native.resize_nearest_f32(arr, dh, dw)
    np.testing.assert_array_equal(
        got, cv2.resize(arr, (dw, dh), interpolation=cv2.INTER_NEAREST))
    np.testing.assert_array_equal(got, jax_native.resize_nearest_f32(arr, dh, dw))


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    cfg = load_config(str(_make_kitti_tree(root, n_train=6, n_val=2)))["kitti"]
    return cfg, readlines(os.path.join(root, "splits", "kitti", "train.txt"))


def _batches(kitti):
    """The training split at 48x80, with its seeded flips and jitter, through
    the loader with one worker."""
    cfg, files = kitti
    dataset = KITTIDataset(cfg["dataset"], cfg["training_data"], files, 48, 80,
                           is_train=True, seed=10)
    return list(DataLoader(dataset, 2, shuffle=False, drop_last=False, num_workers=1))


def test_kitti_samples_equal_with_native_resize(lib, kitti, monkeypatch):
    monkeypatch.delenv("FOOTPRINTS_NATIVE_RESIZE", raising=False)
    ref = _batches(kitti)
    monkeypatch.setenv("FOOTPRINTS_NATIVE_RESIZE", "1")
    got = _batches(kitti)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_native_resize_raises_without_a_compiler(kitti, monkeypatch, tmp_path):
    """No library built and no g++: the dataset raises instead of falling
    back to PIL."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("FOOTPRINTS_NATIVE_RESIZE", "1")
    native.load_library.cache_clear()
    try:
        assert not native.available()
        cfg, files = kitti
        dataset = KITTIDataset(cfg["dataset"], cfg["training_data"], files, 48, 80)
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            dataset[0]
    finally:
        native.load_library.cache_clear()
