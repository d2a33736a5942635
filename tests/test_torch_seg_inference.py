"""The port's segmentation Tester (``segmentation.main --mode inference
--device cpu``) against the JAX Tester from one JAX-written checkpoint.npz
(``Segmentor.init`` + ``save_checkpoint``, untrained) over a synthetic KITTI
train+val split at batch 2 (a padded tail): the ground_seg tree, [1,H,W]
float16 in [0,1], within 2e-3 + 2e-3|jax| of the JAX dump; overlap
byte-identical to the serial order; the weights load from a .pth, a
directory and the .npz alike."""

import os

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from footprints_tpu.models import Segmentor as JaxSegmentor
from footprints_tpu.preprocessing.segmentation.main import main as jax_seg_main
from footprints_tpu.train.checkpoint import save_checkpoint
from footprints_tpu_torch.models import Segmentor
from footprints_tpu_torch.preprocessing.segmentation import datasets
from footprints_tpu_torch.preprocessing.segmentation import inference as seg_inference
from footprints_tpu_torch.preprocessing.segmentation.main import main as seg_main
from footprints_tpu_torch.preprocessing.segmentation.options import Options

H, W = 64, 96
F16_BAR = 2e-3
# train and val lines, unsorted: the Tester dumps their sorted union
TRAIN = ["seq0 3 l", "seq0 0 r", "seq1 1 l"]
VAL = ["seq0 2 l", "seq0 1 l"]


def _tree(root):
    raw = root / "raw"
    rng = np.random.RandomState(0)
    for line in TRAIN + VAL:
        seq, frame, side = line.split()
        folder = raw / seq / ("image_02" if side == "l" else "image_03") / "data"
        os.makedirs(folder, exist_ok=True)
        Image.fromarray(rng.randint(0, 255, (96, 160, 3), np.uint8)).save(
            folder / f"{frame.zfill(10)}.jpg")
    os.makedirs(root / "splits" / "kitti")
    (root / "splits" / "kitti" / "train.txt").write_text("\n".join(TRAIN))
    (root / "splits" / "kitti" / "val.txt").write_text("\n".join(VAL))
    config = root / "paths.yaml"
    config.write_text(yaml.safe_dump({"kitti": {
        "dataset": str(raw), "training_data": str(root / "td")}}))
    return str(config)


def _argv(root, config, load_path, *extra):
    return ["--mode", "inference", "--test_data_type", "kitti",
            "--height", str(H), "--width", str(W), "--batch_size", "2",
            "--num_workers", "1", "--config_path", config,
            "--split_root", str(root / "splits"), "--encoder_depth", "18",
            "--load_path", str(load_path), *extra]


def _tree_files(folder):
    return {os.path.relpath(os.path.join(d, f), folder): os.path.join(d, f)
            for d, _, fs in os.walk(folder) for f in fs}


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    config = _tree(root)
    params, state = JaxSegmentor(18, True).init(jax.random.PRNGKey(3))
    ckpt = root / "epoch_0" / "checkpoint.npz"
    save_checkpoint(str(ckpt), jax.tree.map(np.asarray, {"params": params,
                                                         "state": state}))
    jax_seg_main(_argv(root, config, ckpt.parent, "--test_save_folder", "seg_jax"))
    tester = seg_main(_argv(root, config, ckpt.parent, "--device", "cpu",
                            "--test_save_folder", "seg_port",
                            "--save_test_visualisations"))
    return root, config, ckpt, tester


def test_ground_seg_tree_and_contract(dumps):
    root, *_ = dumps
    files = _tree_files(root / "td" / "seg_port")
    npys = sorted(f for f in files if f.endswith(".npy"))
    assert npys == sorted(["seq0/image_02/data/0000000001.npy",
                           "seq0/image_02/data/0000000002.npy",
                           "seq0/image_02/data/0000000003.npy",
                           "seq0/image_03/data/0000000000.npy",
                           "seq1/image_02/data/0000000001.npy"])
    assert sorted(f for f in files if f.endswith(".jpg")) == sorted(
        f.replace("/data/", "/visualisations/").replace(".npy", ".jpg") for f in npys)
    for f in npys:
        pred = np.load(files[f])
        assert pred.shape == (1, H, W) and pred.dtype == np.float16
        assert pred.min() >= 0 and pred.max() <= 1


def test_ground_seg_matches_jax_tester(dumps):
    root, *_ = dumps
    port = {k: v for k, v in _tree_files(root / "td" / "seg_port").items()
            if k.endswith(".npy")}
    ref = _tree_files(root / "td" / "seg_jax")
    assert sorted(port) == sorted(ref) and len(ref) == 5
    for f, path in ref.items():
        want = np.load(path).astype(np.float32)
        got = np.load(port[f]).astype(np.float32)
        assert got.shape == want.shape
        assert (np.abs(got - want) <= F16_BAR + F16_BAR * np.abs(want)).all(), f


def test_overlap_is_byte_identical_to_serial(dumps):
    root, _, _, tester = dumps
    out = {}
    for overlap in (False, True):
        tester.save_path = str(root / "td" / f"overlap_{overlap}")
        assert tester.test(overlap=overlap) == 5
        out[overlap] = {k: open(v, "rb").read()
                        for k, v in _tree_files(tester.save_path).items()
                        if k.endswith(".npy")}
    assert len(out[True]) == 5 and out[True] == out[False]


def test_weights_load_from_pth_directory_and_npz(dumps, tmp_path):
    _, _, ckpt, tester = dumps
    sd = tester.net.state_dict()
    pth = tmp_path / "epoch_0.pth"
    torch.save(sd, pth)
    for path in (str(pth), str(ckpt.parent), str(ckpt)):
        net = Segmentor(18, True, generator=torch.Generator().manual_seed(99))
        seg_inference.load_segmentor_weights(net, path)
        for k, v in net.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)


def test_training_and_its_datasets_are_not_ported_yet(dumps):
    root, config, ckpt, _ = dumps
    argv = _argv(root, config, ckpt.parent, "--device", "cpu")
    argv[1] = "train"
    with pytest.raises(NotImplementedError, match="segmentation-training slice"):
        seg_main(argv)
    with pytest.raises(NotImplementedError, match="segmentation-training slice"):
        datasets.get_dataset_class("ADE20K")
    assert Options().parse(argv).device == "cpu"


def test_matterport_seg_dataset_reads_the_sample_dataset_tree(tmp_path):
    folder = tmp_path / "sample_dataset/v1/scans/scanA/scanA/matterport_color_images"
    os.makedirs(folder)
    Image.fromarray(np.full((40, 50, 3), 7, np.uint8)).save(folder / "p1_i2_3.jpg")
    ds = datasets.get_inference_dataset_class("matterport")(
        str(tmp_path), ["scanA p1 2 3"], 32, 48)
    sample = ds[0]
    assert sample["image"].shape == (32, 48, 3) and sample["idx"] == 0
    ds.save_result(0, np.zeros((1, 32, 48), np.float32), str(tmp_path / "out"))
    saved = np.load(tmp_path / "out" / "scanA" / "data" / "0000p1_2_3.npy")
    assert saved.dtype == np.float16 and saved.shape == (1, 32, 48)


def test_tester_defaults_to_the_card(dumps):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device would run")
    root, config, ckpt, _ = dumps
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seg_inference.Tester(Options().parse(_argv(root, config, ckpt.parent)))
