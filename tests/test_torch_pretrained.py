"""``--pretrained_encoder`` and ``convert.cli`` of the port
(footprints_tpu_torch/convert/) held against the JAX package's
footprints_tpu/convert/ on the CPU.

The files are synthetic: a torchvision-layout ResNet state_dict (``conv1``,
``bn1``, ``layer1..4``, ``fc``; the BasicBlock names of torchvision, built
on the meta device and filled from a numpy seed) and reference-layout
model state_dicts (the port's FootprintNetwork-18 and Segmentor-18, whose
names are the reference's).  Everything is compared exactly
(np.array_equal): both packages only rename, transpose and copy.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax

from footprints_tpu.convert import cli as jax_cli
from footprints_tpu.convert import encoder_from_torchvision_state_dict as jax_from_tv
from footprints_tpu.convert import load_pretrained_encoder as jax_load_pretrained
from footprints_tpu_torch.checkpoint import load_checkpoint
from footprints_tpu_torch.convert import (cli, encoder_from_torchvision_state_dict,
                                          jax_params_from_state_dict,
                                          load_pretrained_encoder,
                                          resolve_pretrained_encoder)
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import FootprintNetwork, Segmentor
from footprints_tpu_torch.options import Options
from footprints_tpu_torch.train.trainer import TrainManager

from . import torch_oracle
from .test_torch_trainer import _argv
from .test_trainer_e2e import _make_kitti_tree

STAGES = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


class _TorchvisionResnet(nn.Module):
    """torchvision's ResNet-18/34 module names (BasicBlock stages)."""

    def __init__(self, depth):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        c_in = 64
        for i, (c, n) in enumerate(zip((64, 128, 256, 512), STAGES[depth]), 1):
            setattr(self, f"layer{i}", torch_oracle._stage(c_in, c, n, 1 if i == 1 else 2))
            c_in = c
        self.fc = nn.Linear(512, 1000)


def torchvision_state_dict(depth, seed=0):
    """A seeded torchvision-layout ResNet state_dict of CPU f32 tensors."""
    with torch.device("meta"):
        like = _TorchvisionResnet(depth).state_dict()
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in like.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0)
            continue
        a = rng.randn(*v.shape).astype(np.float32) * 0.1
        sd[k] = torch.from_numpy(np.abs(a) + 0.5 if k.endswith("running_var") else a)
    return sd


def _assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path}: torchvision files of depth 18 and 34, and a reference
    FootprintNetwork-18 model.pth (the wrapped encoder layout)."""
    root = tmp_path_factory.mktemp("pretrained")
    out = {}
    for depth in (18, 34):
        out[f"tv{depth}"] = str(root / f"resnet{depth}.pth")
        torch.save(torchvision_state_dict(depth, seed=depth), out[f"tv{depth}"])
    out["wrapped18"] = str(root / "model.pth")
    torch.save(FootprintNetwork(18, generator=torch.Generator().manual_seed(4)).state_dict(),
               out["wrapped18"])
    return out


@pytest.mark.parametrize("depth", [18, 34])
def test_torchvision_state_dict_equals_jax(depth):
    sd = torchvision_state_dict(depth, seed=depth)
    _assert_trees_equal(encoder_from_torchvision_state_dict(sd, depth),
                        jax_from_tv({k: v.numpy() for k, v in sd.items()}, depth))


@pytest.mark.parametrize("name,depth", [("tv18", 18), ("tv34", 34), ("wrapped18", 18)])
def test_load_pretrained_encoder_equals_jax(files, name, depth):
    _assert_trees_equal(load_pretrained_encoder(files[name], depth),
                        jax_load_pretrained(files[name], depth))


@pytest.mark.parametrize("name,depth", [("tv34", 18), ("tv18", 34), ("wrapped18", 34)])
def test_wrong_depth_raises_value_error(files, name, depth):
    with pytest.raises(ValueError, match="encoder_depth"):
        ModelManager(depth=depth, device="cpu", pretrained_encoder=files[name])


def test_other_architecture_raises_value_error():
    """A file that is no torchvision ResNet (a key of neither layout)."""
    sd = torchvision_state_dict(18)
    sd["classifier.weight"] = torch.zeros(10, 512)
    with pytest.raises(ValueError, match="unrecognized"):
        encoder_from_torchvision_state_dict(sd, 18)


def test_missing_file_and_download_raise():
    with pytest.raises(FileNotFoundError):
        ModelManager(depth=18, device="cpu", pretrained_encoder="/nonexistent/resnet18.pth")
    with pytest.raises(NotImplementedError, match="local .pth"):
        resolve_pretrained_encoder("download", 18)


def test_layout_mismatch_raises(files):
    good = load_pretrained_encoder(files["tv18"], 18)
    bad = jax.tree.map(lambda a: a, good[0])
    bad["stem_conv"]["w"] = np.zeros((3, 3, 3, 64), np.float32)  # not 7x7
    with pytest.raises(ValueError, match="layout mismatch"):
        resolve_pretrained_encoder(files["tv18"], 18, expected=(bad, good[1]))
    _assert_trees_equal(resolve_pretrained_encoder(files["tv18"], 18, expected=good), good)


def test_model_manager_starts_from_the_file(files):
    """The encoder equals the file's weights exactly, through the weight
    bridge (its BN statistics too); the decoders keep the seeded init."""
    mm = ModelManager(depth=18, device="cpu", pretrained_encoder=files["tv18"])
    plain = ModelManager(depth=18, device="cpu")
    params, state = jax_params_from_state_dict(mm.net.state_dict(), 18)
    want_p, want_s = jax_load_pretrained(files["tv18"], 18)
    _assert_trees_equal((params["encoder"], state["encoder"]), (want_p, want_s))
    ref = jax_params_from_state_dict(plain.net.state_dict(), 18)[0]
    for dec in ("mask_decoder", "depth_decoder"):
        _assert_trees_equal(params[dec], ref[dec])
    assert not _same(params["encoder"], ref["encoder"])


def _same(a, b):
    return all(np.array_equal(x, y) for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)))


def test_main_trains_from_the_pretrained_encoder(files, tmp_path):
    """main --mode train starts from the file: step 0's encoder is the
    file's, and one epoch trains from it."""
    config = _make_kitti_tree(tmp_path)
    argv = _argv(tmp_path, config, "--pretrained_encoder", files["tv18"])
    tm = TrainManager(Options().parse(argv))
    enc = jax_params_from_state_dict(tm.model_manager.net.state_dict(), 18)
    _assert_trees_equal((enc[0]["encoder"], enc[1]["encoder"]),
                        jax_load_pretrained(files["tv18"], 18))
    tm.train()
    assert tm.step == 1
    assert all(np.isfinite(v) for _, _, losses in tm.logged for v in losses.values())


# --- convert.cli ---------------------------------------------------------------------

@pytest.mark.parametrize("model,extra", [("footprint", ()), ("segmentor", ()),
                                         ("segmentor", ("--no_psp",))],
                         ids=["footprint", "segmentor_psp", "segmentor_no_psp"])
def test_cli_writes_the_jax_cli_checkpoint(tmp_path, model, extra):
    g = torch.Generator().manual_seed(5)
    net = (FootprintNetwork(18, generator=g) if model == "footprint"
           else Segmentor(18, use_psp=not extra, generator=g))
    with torch.no_grad():  # non-trivial BN statistics, so their mapping shows
        for name, buf in net.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=g)
            elif name.endswith("running_mean"):
                buf.normal_(0, 0.1, generator=g)
    pth = str(tmp_path / "model.pth")
    torch.save(net.state_dict(), pth)
    args = ["--input", pth, "--model", model, "--encoder_depth", "18", *extra]
    dest = cli.main(args + ["--output", str(tmp_path / "port")])
    jax_cli.main(args + ["--output", str(tmp_path / "jax")])
    got = load_checkpoint(dest)
    want = load_checkpoint(os.path.join(tmp_path, "jax", "checkpoint.npz"))
    assert sorted(got) == sorted(want) == ["opt_state", "params", "state", "step"]
    assert got["opt_state"] is None and int(got["step"]) == 0
    _assert_trees_equal((got["params"], got["state"]), (want["params"], want["state"]))


def test_cli_checkpoint_loads_back_into_the_model(tmp_path):
    net = FootprintNetwork(18, generator=torch.Generator().manual_seed(6))
    torch.save(net.state_dict(), tmp_path / "model.pth")
    cli.main(["--input", str(tmp_path / "model.pth"), "--output", str(tmp_path / "npz"),
              "--encoder_depth", "18"])
    mm = ModelManager(depth=18, seed=7, device="cpu")
    mm.load_model(str(tmp_path / "npz"))
    for k, v in net.state_dict().items():
        assert torch.equal(mm.net.state_dict()[k], v), k
