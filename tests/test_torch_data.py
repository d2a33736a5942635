"""The port's host data path (footprints_tpu_torch/data/) against the JAX
package's on a synthetic KITTI tree: with the same seed, the same samples
(train mode, so flips and colour jitter are drawn), the same batch order
and the same compact encodings, bit for bit; and the torch decode of a
compact batch equals the numpy decode and the raw f32 batch, bit for bit."""

import os

import numpy as np
import pytest
import torch

from footprints_tpu.core.config import readlines as jreadlines
from footprints_tpu.data import DataLoader as JaxDataLoader
from footprints_tpu.data import KITTIDataset as JaxKITTIDataset
from footprints_tpu.data.compact import BatchCompactor as JaxBatchCompactor
from footprints_tpu.data.compact import decompact_batch_np
from footprints_tpu_torch.core.config import load_config, readlines
from footprints_tpu_torch.data import (BackgroundWriter, DataLoader, DevicePrefetcher,
                                       KITTIDataset, get_dataset_class)
from footprints_tpu_torch.data.compact import BatchCompactor, decompact_on_device

from .test_trainer_e2e import _make_kitti_tree

H, W = 48, 80


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    config = _make_kitti_tree(root, n_train=8, n_val=4)
    cfg = load_config(str(config))["kitti"]
    files = readlines(os.path.join(root, "splits", "kitti", "train.txt"))
    assert files == jreadlines(os.path.join(root, "splits", "kitti", "train.txt"))
    return cfg, files


def _datasets(tree, is_train, **kw):
    cfg, files = tree
    args = (cfg["dataset"], cfg["training_data"], files, H, W)
    return (KITTIDataset(*args, is_train=is_train, seed=10, **kw),
            JaxKITTIDataset(*args, is_train=is_train, seed=10, **kw))


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("is_train", [True, False])
def test_kitti_samples_match_jax_bitwise(tree, is_train):
    port, ref = _datasets(tree, is_train)
    flips = []
    for i in range(len(port)):
        _equal(port[i], ref[i])
        flips.append(port._rng.bit_generator.state == ref._rng.bit_generator.state)
    assert all(flips)


def test_kitti_options_match_jax(tree):
    port, ref = _datasets(tree, True, no_depth_mask=True, moving_objects_method="none")
    for i in range(3):
        _equal(port[i], ref[i])
    with pytest.raises(ValueError, match="project_down_baseline"):
        _datasets(tree, True, project_down_baseline=True)


def test_loader_order_and_batches_match_jax(tree):
    port, ref = _datasets(tree, True)
    pl = DataLoader(port, 3, shuffle=True, num_workers=2, seed=10)
    jl = JaxDataLoader(ref, 3, shuffle=True, num_workers=2, seed=10)
    assert len(pl) == len(jl) == 2
    for _ in range(2):  # two epochs: the shuffle state carries over
        assert [list(b) for b in pl._epoch_batches()] == \
            [list(b) for b in jl._epoch_batches()]
    # one worker: with several, the threads draw the dataset's augmentations
    # in whatever order they reach it, in both packages alike
    pl = DataLoader(port, 3, shuffle=False, num_workers=1, drop_last=False)
    jl = JaxDataLoader(ref, 3, shuffle=False, num_workers=1, drop_last=False)
    batches = list(pl)
    assert len(batches) == 3 and batches[-1]["image"].shape[0] == 2
    for a, b in zip(batches, jl):
        _equal(a, b)


@pytest.mark.parametrize("mode", ["exact", "f16", "none"])
def test_compactor_and_decode_match_jax_bitwise(tree, mode):
    port, ref = _datasets(tree, True)
    batches = list(DataLoader(port, 4, shuffle=True, num_workers=2, seed=3))
    pc, jc = BatchCompactor(mode), JaxBatchCompactor(mode)
    for batch in batches:
        compact = pc(batch)
        _equal(compact, jc(batch))
        assert pc.scheme == jc.scheme
        decoded = decompact_on_device({k: torch.from_numpy(v) for k, v in compact.items()},
                                      pc.scheme)
        host = decompact_batch_np(compact, jc.scheme)
        _equal({k: v.numpy() for k, v in decoded.items()}, host)
        if mode != "f16":  # exact and none transport are lossless
            _equal({k: v.numpy() for k, v in decoded.items()}, batch)
    if mode == "exact":
        assert pc.scheme["image"] == "u8_image" and pc.scheme["visible_ground"] == "u8"


def test_image_decode_is_exact_for_every_code():
    codes = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got = decompact_on_device({"image": torch.from_numpy(codes)}, {"image": "u8_image"})
    np.testing.assert_array_equal(got["image"].numpy(),
                                  codes.astype(np.float32) / np.float32(255.0))


def test_packed_target_keys_are_not_ported():
    with pytest.raises(NotImplementedError):
        decompact_on_device({}, {}, s2d_keys=("depth",))


def test_device_prefetcher_on_cpu_keeps_order_and_decodes():
    batches = [{"x": np.full((2, 3), i, np.uint8)} for i in range(5)]
    out = list(DevicePrefetcher(iter(batches), "cpu", depth=2,
                                decode=lambda b: {k: v.float() for k, v in b.items()}))
    assert [int(b["x"][0, 0]) for b in out] == list(range(5))
    assert all(b["x"].dtype == torch.float32 for b in out)


def test_matterport_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        get_dataset_class("matterport")
    with pytest.raises(KeyError):
        get_dataset_class("nyu")
    assert get_dataset_class("kitti") is KITTIDataset


def test_background_writer_runs_in_order_and_surfaces_errors():
    done = []
    with BackgroundWriter(max_pending=2) as writer:
        for i in range(5):
            writer.submit(done.append, i)
    assert done == list(range(5))

    def boom():
        raise OSError("disk full")

    writer = BackgroundWriter()
    writer.submit(boom)
    with pytest.raises(OSError, match="disk full"):
        writer.close()
