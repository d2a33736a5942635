"""The port's batch dump, ``main --mode inference --device cpu``, against the
JAX package's on a synthetic 5-frame KITTI tree at batch 2 (a padded tail)
from one JAX-written checkpoint: the file layout, float16 [4,H,W] with the
sigmoid on channels 0-1, each file within 2e-3 + 2e-3|jax| of the JAX
dump, the f32 forward before the cast at MAE < 1e-4, overlap byte-identical
to the serial order, the default save path, and Matterport's naming tree."""

import os

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from footprints_tpu.data import KITTIInferenceDataset as JaxKITTIInferenceDataset
from footprints_tpu.data import MatterportInferenceDataset as JaxMatterportInferenceDataset
from footprints_tpu.main import main as jax_main
from footprints_tpu.model_manager import ModelManager as JaxModelManager
from footprints_tpu_torch import main as port_main
from footprints_tpu_torch.data import (KITTIInferenceDataset, MatterportInferenceDataset,
                                       get_inference_dataset_class)
from footprints_tpu_torch.eval.inference import InferenceManager, pad_batch
from footprints_tpu_torch.ops import fused_conv as fc
from footprints_tpu_torch.options import Options

H, W = 64, 96
DEPTH = 18
F16_BAR = 2e-3  # |port - jax| <= F16_BAR + F16_BAR |jax| after the f16 cast


def _kitti_tree(root, n=5):
    raw = root / "raw"
    rng = np.random.RandomState(0)
    os.makedirs(raw / "seq0" / "image_02" / "data")
    lines = []
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (96, 160, 3), np.uint8)).save(
            raw / "seq0" / "image_02" / "data" / f"{str(i).zfill(10)}.jpg")
        lines.append(f"seq0 {i} l")
    os.makedirs(root / "splits" / "kitti")
    (root / "splits" / "kitti" / "test.txt").write_text("\n".join(lines))
    config = root / "paths.yaml"
    config.write_text(yaml.safe_dump({"kitti": {"dataset": str(raw)}}))
    return str(config)


def _matterport_tree(root, n=3):
    raw = root / "raw"
    rng = np.random.RandomState(1)
    lines = []
    for i in range(n):
        scan = f"scan{i % 2}"
        folder = raw / scan / scan / "matterport_color_images"
        os.makedirs(folder, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (128, 160, 3), np.uint8)).save(
            folder / f"pos{i}_i1_{i}.jpg")
        lines.append(f"{scan} pos{i} 1 {i}")
    os.makedirs(root / "splits" / "matterport")
    (root / "splits" / "matterport" / "test.txt").write_text("\n".join(lines))
    config = root / "paths.yaml"
    config.write_text(yaml.safe_dump({"matterport": {"dataset": str(raw)}}))
    return str(config), lines


def _argv(root, config, weights, *extra, data_type="kitti"):
    return ["--mode", "inference", "--inference_data_type", data_type,
            "--height", str(H), "--width", str(W), "--batch_size", "2",
            "--num_workers", "1", "--config_path", config,
            "--split_root", str(root / "splits"), "--encoder_depth", str(DEPTH),
            "--load_path", str(weights), *extra]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """One JAX-written checkpoint; the JAX dump and the port's CPU dump of
    the KITTI tree from it."""
    root = tmp_path_factory.mktemp("kitti")
    config = _kitti_tree(root)
    mm = JaxModelManager(save_folder=str(root / "w"), is_inference=True, depth=DEPTH)
    mm.save_model("weights_0")
    weights = root / "w" / "weights_0"
    jax_main(_argv(root, config, weights, "--inference_save_path", str(root / "jax")))
    manager = port_main.main(_argv(root, config, weights, "--device", "cpu",
                                   "--inference_save_path", str(root / "port"),
                                   "--save_test_visualisations"))
    return root, config, weights, mm, manager


def test_dump_layout_and_contract(dumps):
    root, *_ = dumps
    files = sorted(os.listdir(root / "port"))
    assert [f for f in files if f.endswith(".npy")] == [f"{i:03d}.npy" for i in range(5)]
    assert [f for f in files if f.endswith(".jpg")] == [f"{i:03d}.jpg" for i in range(5)]
    for i in range(5):
        pred = np.load(root / "port" / f"{i:03d}.npy")
        assert pred.shape == (4, H, W) and pred.dtype == np.float16
        assert np.isfinite(pred.astype(np.float32)).all()
        assert pred[:2].min() >= 0 and pred[:2].max() <= 1  # sigmoid on the masks
        assert pred[2:].min() >= 0 and pred[2:].max() <= 1  # sigmoid disparities


def test_dump_matches_jax_dump(dumps):
    root, *_ = dumps
    assert sorted(os.listdir(root / "jax")) == sorted(
        f for f in os.listdir(root / "port") if f.endswith(".npy"))
    for f in os.listdir(root / "jax"):
        got = np.load(root / "port" / f).astype(np.float32)
        ref = np.load(root / "jax" / f).astype(np.float32)
        assert got.shape == ref.shape
        assert (np.abs(got - ref) <= F16_BAR + F16_BAR * np.abs(ref)).all(), f


def test_f32_forward_before_the_cast_matches_jax(dumps):
    root, _, _, mm, manager = dumps
    images = np.stack([manager.dataset[i]["image"] for i in range(2)])
    out, _ = jax.jit(lambda p, s, x: mm.net.apply(p, s, x, train=False))(
        mm.params, mm.state, images)
    ref = np.transpose(np.array(out["1/1"]), (0, 3, 1, 2))
    with torch.inference_mode():
        got = manager.model_manager.net(torch.from_numpy(images), scales=("1/1",))
    assert np.abs(got["1/1"].permute(0, 3, 1, 2).numpy() - ref).mean() < 1e-4
    with torch.inference_mode():
        half = manager.forward(torch.from_numpy(images)).numpy()
    ref[:, :2] = 1 / (1 + np.exp(-ref[:, :2]))
    assert half.dtype == np.float16
    assert (np.abs(half - ref) <= F16_BAR + F16_BAR * np.abs(ref)).all()


def test_overlap_is_byte_identical_to_serial(dumps, tmp_path):
    root, config, weights, _, _ = dumps
    manager = InferenceManager(Options().parse(_argv(root, config, weights, "--device",
                                                     "cpu")))
    outs = {}
    before = fc.fused_conv3x3.launches
    for overlap in (False, True):
        manager.savepath = str(tmp_path / f"overlap_{overlap}")
        assert manager.run(overlap=overlap) == 5
        outs[overlap] = {f: (tmp_path / f"overlap_{overlap}" / f).read_bytes()
                         for f in sorted(os.listdir(manager.savepath))}
    assert len(outs[True]) == 5 and outs[True] == outs[False]
    assert fc.fused_conv3x3.launches == before  # the CPU runs the plain version


def test_default_save_path_is_under_load_path(dumps):
    root, config, weights, _, _ = dumps
    manager = InferenceManager(Options().parse(_argv(root, config, weights, "--device",
                                                     "cpu")))
    assert manager.savepath == os.path.join(str(weights), "kitti_predictions")


def test_pad_batch_keeps_rows_and_zero_fills():
    images = np.random.RandomState(3).rand(3, 4, 5, 3).astype(np.float32)
    padded = pad_batch(images, 5)
    assert padded.shape == (5, 4, 5, 3) and padded.dtype == np.float32
    np.testing.assert_array_equal(padded[:3], images)
    assert not padded[3:].any()
    assert pad_batch(images, 3) is images


def test_matterport_naming_tree(dumps, tmp_path):
    _, _, weights, _, _ = dumps
    config, lines = _matterport_tree(tmp_path)
    out = tmp_path / "preds"
    port_main.main(_argv(tmp_path, config, weights, "--device", "cpu",
                         "--inference_save_path", str(out), data_type="matterport"))
    found = sorted(os.path.relpath(os.path.join(d, f), out)
                   for d, _, fs in os.walk(out) for f in fs)
    assert found == sorted(f"{scan}/{pos}_{h}_{d}.npy"
                           for scan, pos, h, d in (line.split() for line in lines))
    pred = np.load(out / "scan0" / "pos0_1_0.npy")
    assert pred.shape == (4, H, W) and pred.dtype == np.float16


def test_inference_datasets_match_jax_bitwise(dumps, tmp_path):
    root, config, *_ = dumps
    raw = yaml.safe_load(open(config))["kitti"]["dataset"]
    files = open(root / "splits" / "kitti" / "test.txt").read().splitlines()
    mp_config, mp_files = _matterport_tree(tmp_path)
    mp_raw = yaml.safe_load(open(mp_config))["matterport"]["dataset"]
    assert get_inference_dataset_class("kitti") is KITTIInferenceDataset
    assert get_inference_dataset_class("matterport") is MatterportInferenceDataset
    for port, ref in ((KITTIInferenceDataset(raw, files, H, W),
                       JaxKITTIInferenceDataset(raw, files, H, W)),
                      (MatterportInferenceDataset(mp_raw, mp_files, H, W),
                       JaxMatterportInferenceDataset(mp_raw, mp_files, H, W))):
        for i in range(len(ref)):
            a, b = port[i], ref[i]
            assert a["idx"] == b["idx"] == i
            assert a["image"].dtype == b["image"].dtype == np.float32
            np.testing.assert_array_equal(a["image"], b["image"])
    with pytest.raises(KeyError):
        get_inference_dataset_class("nyu")
