"""The port's Matterport training dataset against the JAX package's, bit for
bit, on a synthetic tree (a 16-bit depth PNG, ground_seg and hidden_depth
npys with 0.1 sentinels, one frame without depth_masks), and one
``main --mode train --training_dataset matterport --device cpu`` step."""

import os

import numpy as np
import pytest
import yaml
from PIL import Image

from footprints_tpu.data import DataLoader as JaxDataLoader
from footprints_tpu.data import MatterportDataset as JaxMatterportDataset
from footprints_tpu_torch import main as port_main
from footprints_tpu_torch.data import DataLoader, MatterportDataset, get_dataset_class

H, W = 64, 96  # half the frames: INTER_AREA averages 2x2 blocks
SCAN = "scanA"


def _make_matterport_tree(root, n=6):
    """Frames of 128x192: jpg colour, 16-bit depth png, and the training
    npys; hidden_depth carries exact 0.1 sentinels, a block of which
    survives INTER_AREA as exactly 0.1, and the last frame has no
    depth_masks file."""
    raw, td = root / "raw", root / "td"
    rng = np.random.RandomState(0)
    os.makedirs(raw / SCAN / SCAN / "matterport_color_images")
    os.makedirs(raw / SCAN / SCAN / "matterport_depth_images")
    for sub in ("ground_seg", "hidden_depth", "depth_masks"):
        os.makedirs(td / sub / SCAN / "data")
    lines = []
    for i in range(n):
        pos, h, d = f"pos{i:04d}xx", str(i % 3), str(i % 6)
        lines.append(f"{SCAN} {pos} {h} {d}")
        Image.fromarray(rng.randint(0, 255, (128, 192, 3), np.uint8)).save(
            raw / SCAN / SCAN / "matterport_color_images" / f"{pos}_i{h}_{d}.jpg")
        Image.fromarray((rng.rand(128, 192) * 40000).astype(np.uint16)).save(
            raw / SCAN / SCAN / "matterport_depth_images" / f"{pos}_d{h}_{d}.png")
        stem = f"{pos}_{h}_{d}.npy"
        np.save(td / "ground_seg" / SCAN / "data" / stem,
                rng.rand(1, 128, 192).astype(np.float16))
        hidden = rng.rand(128, 192) * 14  # float64, so 0.1 is the sentinel exactly
        hidden[:40, :40] = 0.1  # missing-pixel sentinel, whole INTER_AREA cells
        hidden[rng.rand(128, 192) > 0.97] = 0.1
        np.save(td / "hidden_depth" / SCAN / "data" / stem, hidden)
        if i < n - 1:
            np.save(td / "depth_masks" / SCAN / "data" / stem,
                    (rng.rand(128, 192) > 0.9).astype(np.float32))
    splits = root / "splits" / "matterport"
    os.makedirs(splits)
    (splits / "train.txt").write_text("\n".join(lines))
    (splits / "val.txt").write_text("\n".join(lines))
    config = root / "paths.yaml"
    config.write_text(yaml.safe_dump({
        "matterport": {"dataset": str(raw), "training_data": str(td)}}))
    return config, lines


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("matterport")
    config, lines = _make_matterport_tree(root)
    cfg = yaml.safe_load(open(config))["matterport"]
    return root, config, cfg, lines


def _datasets(tree, is_train, **kw):
    _, _, cfg, lines = tree
    args = (cfg["dataset"], cfg["training_data"], lines, H, W)
    return (MatterportDataset(*args, is_train=is_train, seed=10, **kw),
            JaxMatterportDataset(*args, is_train=is_train, seed=10, **kw))


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("no_depth_mask", [False, True])
def test_samples_match_jax_bitwise(tree, no_depth_mask):
    port, ref = _datasets(tree, False, no_depth_mask=no_depth_mask)
    for i in range(len(port)):
        a, b = port[i], ref[i]
        _equal(a, b)
        assert a["image"].shape == (H, W, 3)
        assert not a["moving_object_mask"].any()
    last = port[len(port) - 1]  # no depth_masks file: zeros
    assert not last["depth_mask"].any()
    for i in range(len(port)):  # the sentinel block came out as 0
        assert not port[i]["ground_depth"][:20, :20].any()


def test_augmented_batches_match_jax_bitwise(tree):
    """Train mode (flips and colour jitter drawn from the seeded RNG) through
    the loader with one worker: with several, the threads draw the
    augmentations in whatever order they reach the dataset."""
    port, ref = _datasets(tree, True)
    pl = DataLoader(port, 3, shuffle=True, num_workers=1, seed=10)
    jl = JaxDataLoader(ref, 3, shuffle=True, num_workers=1, seed=10)
    batches = list(pl)
    assert len(batches) == 2
    for a, b in zip(batches, jl):
        _equal(a, b)


def test_depth_is_the_png_in_metres(tree):
    root, _, cfg, lines = tree
    scan, pos, h, d = lines[0].split()
    png = Image.open(os.path.join(cfg["dataset"], scan, scan, "matterport_depth_images",
                                  f"{pos}_d{h}_{d}.png"))
    want = np.array(png.resize((W, H), Image.NEAREST)).astype(np.float64) * 0.00025
    port, _ = _datasets(tree, False)
    np.testing.assert_array_equal(port[0]["depth"], want.astype(np.float32))
    assert get_dataset_class("matterport") is MatterportDataset


def test_main_trains_one_matterport_step(tree):
    root, config, _, _ = tree
    manager = port_main.main([
        "--mode", "train", "--training_dataset", "matterport",
        "--height", str(H), "--width", str(W), "--batch_size", "6", "--epochs", "1",
        "--num_workers", "2", "--val_batches", "1", "--log_freq", "1000000",
        "--config_path", str(config), "--log_path", str(root / "logs"),
        "--split_root", str(root / "splits"), "--encoder_depth", "18",
        "--model_name", "mp", "--no_depth_mask", "--device", "cpu"])
    assert manager.step == 1
    assert manager.train_loader.dataset.no_depth_mask
    assert [(mode, step) for mode, step, _ in manager.logged] == [("train", 0), ("val", 0)]
    for _, _, losses in manager.logged:
        assert all(np.isfinite(v) for v in losses.values())
    assert (root / "logs" / "mp" / "models" / "weights_0" / "checkpoint.npz").exists()
