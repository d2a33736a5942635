"""The port's segmentation training (footprints_tpu_torch/preprocessing/
segmentation/: datasets, losses, options, trainer, main --mode train) held
against the JAX package on the CPU, over small synthetic trees in the
layouts of tests/test_segmentation.py's fixtures.

Tolerances:
  * datasets, prepare_size, ConcatDataset, one-worker loader batches and
    the 'exact' compact transport: bit for bit (the same files, seed and
    index order give the same float32 arrays);
  * the seg loss: 1e-6 relative (f32 resizes and masked means);
  * mixed-precision BatchNorm (bf16 input, bf16-rounded scale and bias,
    f32 running statistics): the output within one bf16 ulp of the JAX
    output (|d| <= 2^-7 |ref| + 1e-6, since bf16 keeps 8 significant
    bits: both normalise in f32 and round once, and a value near the
    midpoint of two bf16 numbers may round to either), the running
    statistics within 1e-5;
  * checkpoints: every tensor equal, both ways.

One train step of each dtype against the JAX step, and the fused sites'
bf16 gradients, are in tests/test_torch_seg_step.py.
"""

import os
import signal
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import jax
import jax.numpy as jnp

from footprints_tpu.convert import load_pretrained_encoder as jax_load_pretrained
from footprints_tpu.data.compact import BatchCompactor as JaxBatchCompactor
from footprints_tpu.data.loader import DataLoader as JaxDataLoader
from footprints_tpu.models import Segmentor as JaxSegmentor
from footprints_tpu.nn import layers as jl
from footprints_tpu.preprocessing.segmentation import datasets as jds
from footprints_tpu.preprocessing.segmentation.inference import Tester as JaxTester
from footprints_tpu.preprocessing.segmentation.losses import compute_seg_losses as jax_seg_losses
from footprints_tpu.preprocessing.segmentation.options import Options as JaxOptions
from footprints_tpu.preprocessing.segmentation.trainer import Trainer as JaxTrainer
from footprints_tpu.preprocessing.segmentation.trainer import _load_segmentor_weights
from footprints_tpu_torch.checkpoint import load_checkpoint
from footprints_tpu_torch.convert import segmentor_jax_params_from_state_dict
from footprints_tpu_torch.data.compact import BatchCompactor, decompact_on_device
from footprints_tpu_torch.data.loader import DataLoader
from footprints_tpu_torch.nn import layers as tl
from footprints_tpu_torch.preprocessing.segmentation import datasets as tds
from footprints_tpu_torch.preprocessing.segmentation.losses import compute_seg_losses
from footprints_tpu_torch.preprocessing.segmentation.main import main as seg_main
from footprints_tpu_torch.preprocessing.segmentation.options import Options
from footprints_tpu_torch.preprocessing.segmentation.trainer import Trainer

from ._torch_port import nchw, nhwc
from .test_torch_pretrained import torchvision_state_dict

H, W = 64, 96
SEED = 10
# ADE20K image sizes (h, w) that take each branch of prepare_size at the
# 64x96 feed: larger (crop only), wider (height fits), taller (width fits),
# the same aspect ratio (both sides set to feed_width, then a crop) and
# exactly the feed size (no crop, no draw)
ADE_SIZES = [(120, 200), (48, 160), (100, 90), (32, 48), (64, 96)]
# (R, G) label colours: ADE20K ids 976 and 2131 are ground, 0 and 3079 not
ADE_COLOURS = np.array([[30, 208], [80, 83], [0, 0], [120, 7]], np.uint8)
CITYSCAPES_IDS = np.array([0, 7, 8, 22, 26, 11], np.uint8)
CS_FRAMES = [("train", "cityA", "000001"), ("train", "cityA", "000002"),
             ("train", "cityB", "000003")]
CS_COARSE = ("train", "cityB", "000003")  # no gtFine: read from gtCoarse
MP_FRAMES = ["scanA p1 0 1", "scanA p2 1 0", "scanB p3 2 2"]
KITTI_FRAMES = [f"training/image_2/{i:06d}_10.png" for i in range(3)]


def _save_rgb(path, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path)


def _make_trees(root):
    """ADE20K, Cityscapes, Matterport and kitti-semantics trees, the split
    files of the first two, and paths.yaml.  Returns {name: (datapath,
    filenames)} and the config path."""
    rng = np.random.RandomState(0)
    out = {}
    ade = root / "ade"
    files = []
    for i, (h, w) in enumerate(ADE_SIZES):
        _save_rgb(str(ade / f"img_{i}.jpg"), rng.randint(0, 256, (h, w, 3), np.uint8))
        seg = np.zeros((h, w, 3), np.uint8)
        seg[..., :2] = ADE_COLOURS[rng.randint(0, 4, (h, w))]
        _save_rgb(str(ade / f"img_{i}_seg.png"), seg)
        files.append(f"img_{i}.jpg")
    out["ADE20K"] = (str(ade), files)

    cs = root / "cs"
    for split, city, frame in CS_FRAMES:
        _save_rgb(str(cs / "leftImg8bit" / split / city / f"{frame}_leftImg8bit.png"),
                  rng.randint(0, 256, (900, 320, 3), np.uint8))
        ids = CITYSCAPES_IDS[rng.randint(0, 6, (900, 320))]
        if (split, city, frame) == CS_COARSE:
            path = cs / "gtCoarse" / f"{split}_extra" / city / f"{frame}_gtCoarse_labelIds.png"
        else:
            path = cs / "gtFine" / split / city / f"{frame}_gtFine_labelIds.png"
        os.makedirs(path.parent, exist_ok=True)
        Image.fromarray(ids).save(path)
    out["cityscapes"] = (str(cs), [" ".join(f) for f in CS_FRAMES])

    mp = root / "mp"
    scans = mp / "sample_dataset/v1/scans"
    for line in MP_FRAMES:
        scan, pos, h, d = line.split()
        _save_rgb(str(scans / scan / scan / "matterport_color_images" / f"{pos}_i{h}_{d}.jpg"),
                  rng.randint(0, 256, (128, 160, 3), np.uint8))
        os.makedirs(scans / scan / "nia_ground_masks", exist_ok=True)
        np.save(scans / scan / "nia_ground_masks" / f"out_{pos}_{h}_{d}_visibleground.npy",
                (rng.rand(128, 160) > 0.5).astype(np.float32))
    out["matterport"] = (str(mp), MP_FRAMES)

    ks = root / "kitti_semantics"
    for frame in KITTI_FRAMES:
        _save_rgb(str(ks / frame), rng.randint(0, 256, (75, 248, 3), np.uint8))
        label = ks / frame.replace("image_2", "semantic")
        os.makedirs(label.parent, exist_ok=True)
        Image.fromarray(CITYSCAPES_IDS[rng.randint(0, 6, (75, 248))]).save(label)
    out["kitti"] = (str(ks), KITTI_FRAMES)

    splits = root / "splits"
    for name, train, val in [("ADE20K", files, files[:2] * 2),
                             ("cityscapes", out["cityscapes"][1], out["cityscapes"][1][:2])]:
        os.makedirs(splits / name)
        (splits / name / "train.txt").write_text("\n".join(train))
        (splits / name / "val.txt").write_text("\n".join(val))
    os.makedirs(splits / "kitti")  # the JAX Tester's split (its files are never read)
    (splits / "kitti" / "train.txt").write_text("seq0 0 l")
    (splits / "kitti" / "val.txt").write_text("seq0 1 l")
    config = root / "paths.yaml"
    config.write_text(yaml.safe_dump({
        "ADE20K": {"dataset": str(ade)}, "cityscapes": {"dataset": str(cs)},
        "kitti": {"dataset": str(root / "raw"), "training_data": str(root / "td")}}))
    return out, str(config)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("segtrain")
    data, config = _make_trees(root)
    return root, data, config


def _same_sample(got, ref):
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert np.array_equal(got[k], ref[k]), k


# --- datasets -----------------------------------------------------------------

@pytest.mark.parametrize("size,feed,keep", [
    ((120, 200), (64, 96), True), ((48, 160), (64, 96), True),
    ((100, 90), (64, 96), True), ((32, 48), (64, 96), True),
    ((64, 96), (64, 96), True), ((100, 90), (64, 96), False)])
def test_prepare_size_matches_jax(size, feed, keep):
    """Every branch, the equal-ratio quirk and keep_aspect_ratio=False: the
    same pixels, and the same number of draws from the generator."""
    rng = np.random.RandomState(1)
    image = Image.fromarray(rng.randint(0, 256, (*size, 3), np.uint8))
    labels = Image.fromarray(rng.randint(0, 30, size, np.uint8))
    got_rng, ref_rng = np.random.default_rng(5), np.random.default_rng(5)
    got = tds.prepare_size(image, labels, *feed, got_rng, keep_aspect_ratio=keep)
    ref = jds.prepare_size(image, labels, *feed, ref_rng, keep_aspect_ratio=keep)
    for a, b in zip(got, ref):
        assert a.size == b.size == (feed[1], feed[0])
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert got_rng.random() == ref_rng.random()


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("name", ["ADE20K", "cityscapes", "matterport", "kitti"])
def test_training_datasets_match_jax_bit_for_bit(trees, name, is_train):
    """One seeded generator per dataset, drawn in the JAX package's order:
    the same index order gives the same samples, twice over the files."""
    _, data, _ = trees
    path, files = data[name]
    got = tds.get_dataset_class(name)(path, files, H, W, is_train=is_train, seed=SEED)
    ref = jds.get_dataset_class(name)(path, files, H, W, is_train=is_train, seed=SEED)
    order = [1, 0, 2, *range(len(files))[::-1]]
    for i in order:
        g, r = got[i], ref[i]
        assert g["image"].shape == (H, W, 3)
        _same_sample(g, r)


def test_cityscapes_reads_gtcoarse_where_gtfine_is_missing(trees):
    _, data, _ = trees
    path, files = data["cityscapes"]
    ds = tds.CityscapesDataset(path, files, H, W)
    coarse = files.index(" ".join(CS_COARSE))
    label = np.array(ds._load_annotation(coarse))[..., 0]
    want = np.array(Image.open(os.path.join(
        path, "gtCoarse", "train_extra", "cityB", "000003_gtCoarse_labelIds.png")))
    assert np.array_equal(label, want)
    sample = ds[coarse]
    # unlabelled pixels (id 0) masked out; ground ids 7, 8 and 22 in the mask
    assert 0 < sample["labelled_pix"].mean() < 1 and sample["ground_mask"].max() == 1
    assert not (sample["ground_mask"] > sample["labelled_pix"]).any()


def test_concat_dataset_and_one_worker_loader_match_jax(trees):
    """ConcatDataset across the ADE20K/cityscapes boundary, then a shuffled
    one-worker loader over it, batch for batch."""
    _, data, _ = trees

    def concat(mod):
        return mod.ConcatDataset([mod.get_dataset_class(n)(*data[n], H, W, is_train=True,
                                                           seed=SEED)
                                  for n in ("ADE20K", "cityscapes")])

    got, ref = concat(tds), concat(jds)
    assert len(got) == len(ref) == 8
    for i in (6, 4, 5, 0):
        _same_sample(got[i], ref[i])
    got_loader = DataLoader(concat(tds), 3, shuffle=True, num_workers=1, seed=SEED)
    ref_loader = JaxDataLoader(concat(jds), 3, shuffle=True, num_workers=1, seed=SEED)
    batches = 0
    for _ in range(2):  # two epochs: the shuffle and the draws go on
        for g, r in zip(got_loader, ref_loader):
            _same_sample(g, r)
            batches += 1
    assert batches == 4


def test_exact_compact_transport_round_trips_a_seg_batch(trees):
    """u8 image and u8 masks on the wire, bitwise equal after the device
    decode, and the same wire bytes as the JAX compactor's."""
    _, data, _ = trees
    ds = tds.ConcatDataset([tds.get_dataset_class(n)(*data[n], H, W, is_train=True, seed=SEED)
                            for n in ("ADE20K", "cityscapes")])
    loader = DataLoader(ds, 4, shuffle=True, num_workers=1, seed=SEED)
    compactor, jcompactor = BatchCompactor("exact"), JaxBatchCompactor("exact")
    for host in loader:
        compact, jcompact = compactor(host), jcompactor(host)
        assert compactor.scheme == {"image": "u8_image", "ground_mask": "u8",
                                    "labelled_pix": "u8"}
        for k, v in compact.items():
            assert v.dtype == np.uint8 and np.array_equal(v, np.asarray(jcompact[k])), k
        decoded = decompact_on_device({k: torch.from_numpy(v) for k, v in compact.items()},
                                      compactor.scheme)
        for k, v in host.items():
            assert decoded[k].dtype == torch.float32
            assert np.array_equal(decoded[k].numpy(), v), k


# --- loss and mixed BatchNorm -------------------------------------------------

def test_seg_loss_matches_jax():
    rng = np.random.RandomState(7)
    n, h, w = 2, 32, 48
    outputs = [(rng.randn(n, h // s, w // s, 1) * 3).astype(np.float32) for s in (8, 4, 2, 1)]
    ground = (rng.rand(n, h, w) > 0.5).astype(np.float32)
    labelled = (rng.rand(n, h, w) > 0.3).astype(np.float32)
    labelled[1, :, : w // 2] = 0  # an image with a large unlabelled part
    ref = jax_seg_losses([jnp.asarray(o) for o in outputs], jnp.asarray(ground),
                         jnp.asarray(labelled))
    got = compute_seg_losses([torch.from_numpy(o) for o in outputs], torch.from_numpy(ground),
                             torch.from_numpy(labelled))
    assert sorted(got) == sorted(ref) and len(got) == 5
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-6, atol=0, err_msg=k)


def test_seg_loss_upcasts_bf16_logits():
    rng = np.random.RandomState(8)
    outputs = [rng.randn(2, 16 // s, 24 // s, 1).astype(np.float32) for s in (8, 4, 2, 1)]
    ground = torch.from_numpy((rng.rand(2, 16, 24) > 0.5).astype(np.float32))
    labelled = torch.ones(2, 16, 24)
    bf16 = [torch.from_numpy(o).to(torch.bfloat16) for o in outputs]
    got = compute_seg_losses(bf16, ground, labelled)
    ref = compute_seg_losses([o.float() for o in bf16], ground, labelled)
    assert got["loss"].dtype == torch.float32
    assert got["loss"].item() == ref["loss"].item()


def test_seg_loss_gradient_at_zero_logits():
    """The loss's gradient is (sigmoid(x) - t) labelled / (count + 1e-7) /
    N / 4 at every pixel of the full-resolution map, also where a logit is
    exactly 0 (bf16 logits on the card are, where a bias cancels a conv's
    rounded output); away from 0 it is the JAX loss's gradient.  At 0 the
    JAX function's jnp.maximum gives -t instead of sigmoid(0) - t."""
    rng = np.random.RandomState(11)
    n, h, w = 2, 16, 24
    outputs = [rng.randn(n, h // s, w // s, 1).astype(np.float32) for s in (8, 4, 2, 1)]
    zero = np.zeros((n, h, w), bool)
    zero[:, ::3, ::2] = True
    outputs[3][zero] = 0.0
    ground = (rng.rand(n, h, w) > 0.5).astype(np.float32)
    labelled = (rng.rand(n, h, w) > 0.2).astype(np.float32)
    leaves = [torch.from_numpy(o).requires_grad_() for o in outputs]
    compute_seg_losses(leaves, torch.from_numpy(ground), torch.from_numpy(labelled))["loss"].backward()
    got = leaves[3].grad.numpy()[..., 0].astype(np.float64)
    x = outputs[3][..., 0].astype(np.float64)
    count = labelled.sum((1, 2), keepdims=True).astype(np.float64)
    want = (1 / (1 + np.exp(-x)) - ground) * labelled / (count + 1e-7) / n / 4
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)
    ref = jax.grad(lambda o: jax_seg_losses(
        [jnp.asarray(a) for a in outputs[:3]] + [o], jnp.asarray(ground),
        jnp.asarray(labelled))["loss"])(jnp.asarray(outputs[3]))
    ref = np.asarray(ref)[..., 0]
    np.testing.assert_allclose(got[~zero], ref[~zero], rtol=1e-5, atol=1e-12)
    labelled_zero = zero & (labelled > 0)
    assert labelled_zero.any()
    np.testing.assert_allclose(ref[labelled_zero], (-ground * labelled / count / n / 4)[labelled_zero],
                               rtol=1e-5)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_mixed_batch_norm_matches_jax(train):
    """bf16 activations, the bf16-rounded scale and bias, f32 running stats:
    statistics and normalisation in f32, the output in bf16."""
    rng = np.random.RandomState(9)
    c = 16
    x = jnp.asarray(rng.randn(2, 6, 10, c) * 3 + 1, jnp.bfloat16)
    scale = jnp.asarray(rng.rand(c) + 0.5, jnp.bfloat16)
    bias = jnp.asarray(rng.randn(c), jnp.bfloat16)
    state = {"mean": rng.randn(c).astype(np.float32), "var": rng.rand(c).astype(np.float32) + 0.1}
    ref, ref_state = jl.batch_norm(x, {"scale": scale, "bias": bias}, state, train=train)
    assert ref.dtype == jnp.bfloat16

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)

    xt = nchw(np.asarray(x, np.float32)).to(torch.bfloat16)
    mean, var = torch.from_numpy(state["mean"].copy()), torch.from_numpy(state["var"].copy())
    got = tl.batch_norm(xt, t(scale), t(bias), mean, var, training=train)
    assert got.dtype == torch.bfloat16 and mean.dtype == var.dtype == torch.float32
    got = nhwc(got.float())
    want = np.asarray(ref, np.float32)
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_state["mean"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(var.numpy(), np.asarray(ref_state["var"]), atol=1e-5, rtol=0)


def test_f32_batch_norm_is_unchanged():
    """The f32 path stays F.batch_norm itself, bit for bit."""
    rng = np.random.RandomState(10)
    x = torch.from_numpy(rng.randn(2, 8, 5, 7).astype(np.float32))
    w, b = torch.rand(8) + 0.5, torch.randn(8)
    for training in (True, False):
        m1, v1, m2, v2 = torch.zeros(8), torch.ones(8), torch.zeros(8), torch.ones(8)
        got = tl.batch_norm(x, w, b, m1, v1, training=training)
        ref = torch.nn.functional.batch_norm(x, m2, v2, w, b, training=training)
        assert torch.equal(got, ref) and torch.equal(m1, m2) and torch.equal(v1, v2)


# --- the trainer through the entry point --------------------------------------

def _argv(root, config, *extra):
    return ["--mode", "train", "--training_datasets", "ADE20K", "cityscapes",
            "--height", str(H), "--width", str(W), "--batch_size", "2",
            "--epochs", "1", "--num_workers", "1", "--val_batches", "1",
            "--log_freq", "1000", "--config_path", config,
            "--split_root", str(root / "splits"), "--encoder_depth", "18",
            "--log_path", str(root / "logs"), *extra]


@pytest.fixture(scope="module")
def trained(trees):
    """One epoch (4 steps at batch 2) through main --mode train --device
    cpu, with image panels; returns (root, config, trainer)."""
    root, _, config = trees
    trainer = seg_main(_argv(root, config, "--device", "cpu", "--model_name", "seg",
                             "--log_images"))
    return root, config, trainer


def test_trainer_trains_validates_and_checkpoints(trained):
    root, _, trainer = trained
    assert trainer.step == 4 and trainer.epoch == 0
    # logged and validated at step 0 (0 % log_freq == 0), not after
    assert [(m, s) for m, s, _ in trainer.logged] == [("train", 0), ("val", 0)]
    for _, _, losses in trainer.logged:
        assert sorted(losses) == ["ground_loss_0", "ground_loss_1", "ground_loss_2",
                                  "ground_loss_3", "loss"]
        assert all(np.isfinite(v) for v in losses.values())
    rest = trainer.evaluator.get_averaged_losses("train")
    assert np.isfinite(rest["loss"])  # steps 1-3, not logged yet
    models = root / "logs" / "seg" / "models"
    assert sorted(os.listdir(models)) == ["epoch_0"]
    # tensorboard scalars and [image | gt | prediction] panels, train and val
    for mode in ("train", "val"):
        assert any(f.startswith("events.") for f in os.listdir(root / "logs" / "seg" / mode))
    loaded = load_checkpoint(str(models / "epoch_0" / "checkpoint.npz"))
    assert sorted(loaded) == ["params", "state"]  # no optimizer state
    params, state = segmentor_jax_params_from_state_dict(trainer.net.state_dict(), 18, True)
    for a, b in zip(jax.tree.leaves((params, state)), jax.tree.leaves(
            (loaded["params"], loaded["state"]))):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    assert trainer.lr == pytest.approx(1e-4)


def test_port_checkpoint_loads_in_the_jax_package(trained):
    """epoch_0/checkpoint.npz -> the JAX _load_segmentor_weights and Tester:
    every tensor equal, in the JAX Segmentor's own pytree structure."""
    root, config, trainer = trained
    ckpt = root / "logs" / "seg" / "models" / "epoch_0"
    want = segmentor_jax_params_from_state_dict(trainer.net.state_dict(), 18, True)
    jnet = JaxSegmentor(18, True)
    # the JAX Trainer initialises under this device context too: one
    # compile of the eager init serves both tests
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        got = _load_segmentor_weights(jnet, str(ckpt))
        tester = JaxTester(JaxOptions().parse([
            "--mode", "inference", "--test_data_type", "kitti", "--height", str(H),
            "--width", str(W), "--batch_size", "2", "--num_workers", "1",
            "--config_path", config, "--split_root", str(root / "splits"),
            "--encoder_depth", "18", "--load_path", str(ckpt)]))
        structure = jax.tree.structure(jnet.init(jax.random.PRNGKey(0)))
    for loaded in (got, (tester.params, tester.state)):
        assert jax.tree.structure(loaded) == structure
        for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(want)):
            assert np.array_equal(np.asarray(a), b)


def test_jax_trainer_checkpoint_loads_in_the_port_trainer(trees, tmp_path):
    """A checkpoint written by the JAX Trainer's save_model -> the port's
    Trainer through --load_path: every tensor equal."""
    root, _, config = trees
    jargv = _argv(root, config, "--model_name", "jax", "--batch_size", "8")
    jargv[jargv.index("--log_path") + 1] = str(tmp_path)
    jtrainer = JaxTrainer(JaxOptions().parse(jargv))
    jtrainer.epoch = 0
    jtrainer.save_model()
    ckpt = tmp_path / "jax" / "models" / "epoch_0"
    trainer = Trainer(Options().parse(_argv(root, config, "--device", "cpu",
                                            "--load_path", str(ckpt))))
    got = segmentor_jax_params_from_state_dict(trainer.net.state_dict(), 18, True)
    want = (jtrainer.train_state["params"], jtrainer.train_state["state"])
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.array_equal(a, np.asarray(b))


def test_sigterm_writes_epoch_interrupt_and_restores_the_handler(trees, tmp_path):
    root, _, config = trees
    argv = _argv(root, config, "--device", "cpu", "--epochs", "2", "--model_name", "stop")
    argv[argv.index("--log_path") + 1] = str(tmp_path)
    trainer = Trainer(Options().parse(argv))
    step, sent = trainer.train_step, []

    def step_then_sigterm(i, batch):
        out = step(i, batch)
        if not sent:
            sent.append(i)
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.train_step = step_then_sigterm
    before = signal.getsignal(signal.SIGTERM)
    trainer.train()
    models = tmp_path / "stop" / "models"
    assert sorted(os.listdir(models)) == ["epoch_interrupt"]
    assert trainer.step == 1 and sent == [0]
    assert signal.getsignal(signal.SIGTERM) is before


def test_bf16_training_keeps_f32_masters(trees, tmp_path):
    """--compute_dtype bfloat16: finite losses, f32 master params and
    checkpoint, f32 validation (the eval step applies the f32 params)."""
    root, _, config = trees
    argv = _argv(root, config, "--device", "cpu", "--compute_dtype", "bfloat16",
                 "--model_name", "bf16")
    argv[argv.index("--log_path") + 1] = str(tmp_path)
    trainer = seg_main(argv)
    assert trainer.compute_dtype == torch.bfloat16 and trainer.step == 4
    assert all(p.dtype == torch.float32 for p in trainer.net.parameters())
    assert all(np.isfinite(v) for _, _, losses in trainer.logged for v in losses.values())
    loaded = load_checkpoint(str(tmp_path / "bf16" / "models" / "epoch_0" / "checkpoint.npz"))
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(loaded))
    assert all(torch.isfinite(p).all() for p in trainer.net.parameters())


def test_train_defaults_to_the_card(trees):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device would run")
    root, _, config = trees
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seg_main(_argv(root, config))


def test_pretrained_encoder_missing_file_raises(trees):
    root, _, config = trees
    with pytest.raises(FileNotFoundError):
        Trainer(Options().parse(_argv(root, config, "--device", "cpu",
                                      "--pretrained_encoder", "x.pth")))


def test_trainer_starts_from_the_pretrained_encoder(trees, tmp_path):
    """The Segmentor's encoder equals a torchvision-layout file's weights
    exactly, as the JAX package's loader reads them; the decoder and PSP
    keep the seeded init."""
    root, _, config = trees
    path = str(tmp_path / "resnet18.pth")
    torch.save(torchvision_state_dict(18, seed=8), path)
    trainer = Trainer(Options().parse(_argv(root, config, "--device", "cpu",
                                            "--pretrained_encoder", path)))
    plain = Trainer(Options().parse(_argv(root, config, "--device", "cpu")))
    for t in (trainer, plain):
        t.val_iter.close()
    params, state = segmentor_jax_params_from_state_dict(trainer.net.state_dict(), 18, True)
    want = jax_load_pretrained(path, 18)
    for got, ref in zip((params["encoder"], state["encoder"]), want):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert np.array_equal(a, b)
    ref = plain.net.state_dict()
    for k, v in trainer.net.state_dict().items():
        if k.startswith("decoder."):
            assert torch.equal(v, ref[k]), k


def test_options_keep_the_jax_defaults():
    got, ref = vars(Options().parse([])), vars(JaxOptions().parse([]))
    assert set(got) - set(ref) == {"device"} and got.pop("device") == "cuda"
    assert got == ref


def test_matterport_train_list_is_capped(monkeypatch, tmp_path):
    """create_dataloaders keeps the first 5,000 Matterport train lines."""
    from footprints_tpu_torch.preprocessing.segmentation import trainer as seg_trainer

    os.makedirs(tmp_path / "matterport")
    lines = [f"scan p{i} 0 0" for i in range(5003)]
    (tmp_path / "matterport" / "train.txt").write_text("\n".join(lines))
    (tmp_path / "matterport" / "val.txt").write_text("\n".join(lines[:4]))
    opt = SimpleNamespace(training_datasets=["matterport"], split_root=str(tmp_path),
                          height=H, width=W, batch_size=2, num_workers=4)
    config = tmp_path / "paths.yaml"
    config.write_text(yaml.safe_dump({"matterport": {"dataset": "unused"}}))
    opt.config_path = str(config)
    train, val = seg_trainer.Trainer.create_dataloaders(SimpleNamespace(opt=opt))
    assert train.dataset.datasets[0].filenames == lines[:5000]
    assert len(val) == 2 and val.num_workers == 2 and val.drop_last
