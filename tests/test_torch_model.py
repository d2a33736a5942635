"""The port's FootprintNetwork, weight bridge, checkpoint reader and model
manager held against the JAX package (and the test-only torch oracle of the
reference).  Whole-model bar: MAE < 1e-4 at every scale, the bar of
tests/test_parity_full_res.py."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.model_manager import ModelManager as JaxModelManager
from footprints_tpu.models import FootprintNetwork as JaxFootprintNetwork
from footprints_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from footprints_tpu.train.checkpoint import save_checkpoint
from footprints_tpu_torch.checkpoint import load_checkpoint
from footprints_tpu_torch.convert import state_dict_from_jax_params
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import SCALES, FootprintNetwork, Segmentor
from footprints_tpu_torch.models.footprint import FUSED_BLOCKS, FUSED_PRE_CONCAT, kernel_sites
from footprints_tpu_torch.ops import fused_conv, fused_conv3x3

from . import torch_oracle
from ._torch_port import jax_model, nchw

MAE_BAR = 1e-4


def _compare(got, ref, bar=MAE_BAR):
    assert set(got) == set(ref) == set(SCALES)
    for k in SCALES:
        g, r = got[k].detach().numpy(), np.asarray(ref[k])
        assert g.shape == r.shape, (k, g.shape, r.shape)
        mae = np.abs(g - r).mean()
        assert mae < bar, f"scale {k}: MAE {mae}"


@pytest.mark.parametrize("depth", [18, 34, 50])
def test_all_scales_match_jax_64x128(depth):
    jnet, params, state, net = jax_model(depth, seed=depth + 1)
    x = np.random.RandomState(0).rand(2, 64, 128, 3).astype(np.float32)
    ref, _ = jnet.apply(params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got["1/1"].shape == (2, 64, 128, 4)
    _compare(got, ref)


@pytest.mark.parametrize("h,w", [(192, 640), (256, 448), (512, 640)])
def test_all_scales_match_jax_native_resolutions(h, w):
    """The published models' shapes: kitti, handheld, matterport."""
    jnet, params, state, net = jax_model(34, seed=7)
    x = np.random.RandomState(1).rand(1, h, w, 3).astype(np.float32)
    ref, _ = jnet.apply(params, state, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _compare(got, ref)


def test_serving_forward_computes_only_the_asked_scales():
    net = FootprintNetwork(18, generator=torch.Generator().manual_seed(2)).eval()
    x = torch.rand(1, 64, 96, 3, generator=torch.Generator().manual_seed(3))
    before = fused_conv3x3.launches
    with torch.no_grad():
        full = net(x)
        served = net(x, scales=("1/1",))
    assert list(served) == ["1/1"]
    torch.testing.assert_close(served["1/1"], full["1/1"], rtol=0, atol=0)
    assert fused_conv3x3.launches == before  # CPU: plain versions, no kernel


@pytest.mark.parametrize("depth", [18, 34, 50])
def test_decoders_fuse_block2_and_block4_only(depth):
    """Every SkipDecoder (both of a FootprintNetwork, the Segmentor's with
    and without the PSP) runs the post-concat ConvBlocks of block2 and
    block4 through the kernel, and leaves blocks 1 and 3 on cuDNN."""
    fp = FootprintNetwork(depth)
    decoders = [fp.mask_decoder, fp.depth_decoder, Segmentor(depth, True).decoder,
                Segmentor(depth, False).decoder]
    for decoder in decoders:
        assert [getattr(decoder, f"block{i}").fused for i in range(1, 5)] == [
            False, True, False, True]


def _record_kernel_calls(monkeypatch):
    """Records every call of the fused kernel at the wrappers' entry
    (ops/fused_conv.py:_fused) as (pad_mode, input NHWC shape, Co,
    residual?, bias?, act), and lets it run."""
    calls, run = [], fused_conv._fused

    def record(x, w, b, residual, pad_mode, act):
        calls.append((pad_mode, tuple(x.shape), w.shape[0], residual is not None,
                      b is not None, act))
        return run(x, w, b, residual, pad_mode, act)

    monkeypatch.setattr(fused_conv, "_fused", record)
    return calls


@pytest.mark.parametrize("model,depth,hw", [
    ("footprint", 18, (192, 640)), ("footprint", 34, (192, 640)), ("footprint", 50, (192, 640)),
    ("segmentor_psp", 34, (192, 640)), ("segmentor", 34, (192, 640)),
    ("footprint", 34, (512, 640))],
    ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v))
def test_kernel_sites_are_the_calls_of_a_forward(monkeypatch, model, depth, hw):
    """kernel_sites lists the fused kernel's calls that a CPU forward with
    every head makes, in order, with their pad modes, input shapes, Co,
    residual, bias and activation; a decoder's sites are the post-concat
    ConvBlocks of FUSED_BLOCKS (3 calls each: conv1's two halves, conv2),
    the pre-concat ConvBlocks of FUSED_PRE_CONCAT (2) and the tail (2)."""
    net = (FootprintNetwork(depth) if model == "footprint"
           else Segmentor(depth, use_psp=model == "segmentor_psp"))
    calls = _record_kernel_calls(monkeypatch)
    with torch.no_grad():
        net(torch.rand(1, *hw, 3, generator=torch.Generator().manual_seed(depth)))
    monkeypatch.undo()
    sites = kernel_sites(net, 1, *hw)
    assert [site[1:] for site in sites] == calls
    decoders = 2 if model == "footprint" else 1
    per_decoder = 3 * len(FUSED_BLOCKS) + 2 * len(FUSED_PRE_CONCAT) + 2
    assert len(sites) == decoders * per_decoder
    names = [site[0] for site in sites]
    assert len(set(names)) == len(names)
    blocks = {re.match(r"\w+\.(block\d\.(?:pre|post)|tail)\.", name).group(1) for name in names}
    assert blocks == ({f"block{i}.post" for i in FUSED_BLOCKS}
                      | {f"block{i}.pre" for i in FUSED_PRE_CONCAT} | {"tail"})
    for name, pad_mode, _, _, residual, bias, act in sites:
        if name.endswith("up_half"):  # conv1's first input channels, upsampled
            assert (pad_mode, residual, bias, act) == ("up2_reflect", False, False, "none")
        elif name.endswith("skip_half"):  # the rest, with the up half as its residual
            assert (pad_mode, residual, bias) == ("reflect", True, True)


def test_forward_keeps_channels_last_activations():
    """The kernel sites expect NHWC bytes; the model's activations stay in
    channels_last so the permutes there are views."""
    net = FootprintNetwork(18).eval()
    x = torch.rand(1, 64, 96, 3)
    with torch.no_grad():
        feats = net.encoder(x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last))
    for f in feats:
        assert f.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("depth", [18, 34, 50])
def test_bridge_fills_every_port_key(depth):
    params, state = JaxFootprintNetwork(depth).init(jax.random.PRNGKey(0))
    sd = state_dict_from_jax_params(params, state, depth)
    port = FootprintNetwork(depth).state_dict()
    assert set(sd) == set(port)
    for k, v in sd.items():
        assert v.shape == port[k].shape and v.dtype == port[k].dtype, k
    # keys the JAX pytree lacks get torch's defaults
    bn = "mask_decoder.block4.post_concat_conv.bn2"
    assert torch.equal(sd[bn + ".weight"], torch.ones(64))
    assert torch.equal(sd[bn + ".running_mean"], torch.zeros(64))
    assert int(sd["encoder.layer0.1.num_batches_tracked"]) == 0
    # HWIO -> OIHW
    w = np.asarray(params["depth_decoder"]["outconv4_out"]["conv1"]["w"])
    np.testing.assert_array_equal(
        sd["depth_decoder.outconv4.1.conv1.weight"].numpy(),
        np.transpose(w, (3, 2, 0, 1)))


def test_torch_oracle_state_dict_loads_strictly():
    torch.manual_seed(10)
    oracle = torch_oracle.FootprintNetwork().eval()
    net = FootprintNetwork(34).eval()
    net.load_state_dict(oracle.state_dict(), strict=True)
    x = np.random.RandomState(2).rand(2, 64, 96, 3).astype(np.float32)
    with torch.no_grad():
        ref = oracle(nchw(x))
        got = net(torch.from_numpy(x))
    for k in SCALES:
        np.testing.assert_allclose(got[k].numpy(),
                                   ref[k].permute(0, 2, 3, 1).numpy(), atol=1e-5)


@pytest.mark.parametrize("zip_format", [True, False])
def test_model_manager_loads_model_pth(tmp_path, zip_format):
    src = FootprintNetwork(34, generator=torch.Generator().manual_seed(4))
    torch.save(src.state_dict(), str(tmp_path / "model.pth"),
               _use_new_zipfile_serialization=zip_format)
    mm = ModelManager(device="cpu")
    mm.load_model(str(tmp_path))
    assert not mm.net.training
    for k, v in src.state_dict().items():
        assert torch.equal(mm.net.state_dict()[k], v), k


def test_model_manager_loads_jax_checkpoint_npz(tmp_path):
    """A checkpoint.npz written by the JAX ModelManager (save_checkpoint)
    loads through the port's ModelManager and serves the same outputs."""
    jmm = JaxModelManager(save_folder=str(tmp_path), is_inference=True, seed=3)
    jmm.save_model("weights_0")
    mm = ModelManager(device="cpu")
    mm.load_model(str(tmp_path / "weights_0"))
    x = np.random.RandomState(3).rand(1, 64, 96, 3).astype(np.float32)
    ref, _ = jmm.net.apply(jmm.params, jmm.state, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = mm.net(torch.from_numpy(x))
    _compare(got, ref)


def test_model_manager_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ModelManager(device="cpu").load_model(str(tmp_path))


def _same_tree(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    elif a is not None:
        np.testing.assert_array_equal(a, b)


def test_checkpoint_reader_matches_jax_reader(tmp_path):
    tree = {
        "params": {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "layers": [{"w": np.ones(2)}, {"w": np.zeros(3), "b": None}],
                   "empty": {}},
        "state": {"pair": (np.int32(3), np.float32(1.5)), "none_list": []},
        "step": np.zeros((), np.int32),
    }
    path = tmp_path / "checkpoint.npz"
    save_checkpoint(str(path), tree)
    _same_tree(load_checkpoint(str(path)), jax_load_checkpoint(str(path)))
