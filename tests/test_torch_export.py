"""The port's serving export (footprints_tpu_torch/export.py) on the CPU,
held against the JAX package's serving forwards (footprints_tpu/export.py)
on the same weights, and the custom op the artifact carries.

Settings: FootprintNetwork-18 and Segmentor-18 (PSP) at 64x96, batch 2, the
port's seeded weights with non-trivial BN carried into the JAX layout by
the bridge, seed-0 numpy inputs.  Bars: an f32 artifact within 1e-5 of the
port's live forward and MAE < 1e-4 of the JAX one (the bar of
tests/test_parity_full_res.py); a bf16 artifact's per-channel MAE against
the JAX f32 forward at most twice that of the JAX bf16 serving forward
+ 1e-3 (bf16 rounds at other places in the two frameworks); the Segmentor's
f16 map within 1e-3 of the JAX one (tests/test_export.py's bar)."""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from footprints_tpu.export import build_segmentor_forward as jax_segmentor_forward
from footprints_tpu.export import build_serving_forward as jax_serving_forward
from footprints_tpu.models import FootprintNetwork as JaxFootprintNetwork
from footprints_tpu.models import Segmentor as JaxSegmentor
from footprints_tpu_torch import export, predict_simple
from footprints_tpu_torch.convert import (jax_params_from_state_dict,
                                          segmentor_jax_params_from_state_dict,
                                          segmentor_state_dict_from_jax_params,
                                          state_dict_from_jax_params)
from footprints_tpu_torch.models import FootprintNetwork, Segmentor
from footprints_tpu_torch.models.footprint import kernel_sites
from footprints_tpu_torch.ops import fused_conv as fc

from ._torch_port import _randomise_bn

H, W, B, DEPTH = 64, 96, 2, 18
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CYCLIST = os.path.join(REPO, "test_data", "cyclist.jpg")
# the JAX sidecar's keys, with the port's torch_version in place of JAX's
# calling_convention_version
META_KEYS = {"format_version", "encoder_depth", "height", "width", "batch", "dtype",
             "platforms", "input", "bytes", "torch_version", "model", "output",
             "channels"}


def _images(n=B, seed=0):
    return np.random.RandomState(seed).rand(n, H, W, 3).astype(np.float32)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(weights dir with the port's model.pth, JAX params, JAX state)."""
    seeded = FootprintNetwork(DEPTH, generator=torch.Generator().manual_seed(3))
    params, state = jax_params_from_state_dict(seeded.state_dict(), DEPTH)
    rng = np.random.RandomState(3)
    params, state = _randomise_bn(params, rng), _randomise_bn(state, rng)
    folder = tmp_path_factory.mktemp("weights")
    torch.save(state_dict_from_jax_params(params, state, DEPTH),
               str(folder / "model.pth"))
    return str(folder), params, state


def _export(model, folder, dtype, batch=B, **kw):
    out = str(folder / f"model_{dtype}.pt2")
    meta = export.export_serving(model[0], out, height=H, width=W, batch=batch,
                                 dtype=dtype, platforms=("cpu",), depth=DEPTH, **kw)
    return out, meta


@pytest.fixture(scope="module")
def f32_artifact(model, tmp_path_factory):
    return _export(model, tmp_path_factory.mktemp("f32"), "float32")


@pytest.fixture(scope="module")
def bf16_artifact(model, tmp_path_factory):
    return _export(model, tmp_path_factory.mktemp("bf16"), "bfloat16")


def _live(folder, x):
    net = FootprintNetwork(DEPTH).eval()
    net.load_state_dict(torch.load(os.path.join(folder, "model.pth")))
    with torch.no_grad():
        return net(torch.from_numpy(x), scales=("1/1",))["1/1"].permute(0, 3, 1, 2).numpy()


def _jax_forward(model, x, dtype):
    _, params, state = model
    fn = jax_serving_forward(JaxFootprintNetwork(DEPTH), params, state, dtype)
    return np.asarray(jax.jit(fn)(jnp.asarray(x)))


@pytest.fixture(scope="module")
def jax_f32(model):
    """The JAX f32 serving forward of the seed-0 images."""
    return _jax_forward(model, _images(), "float32")


def test_f32_artifact_matches_live_forward_and_jax(model, f32_artifact, jax_f32):
    x = _images()
    got = export.load_serving(f32_artifact[0], device="cpu").call(x)
    assert got.shape == (B, 4, H, W) and got.dtype == np.float32
    np.testing.assert_allclose(got, _live(model[0], x), atol=1e-5, rtol=1e-5)
    assert np.abs(got - jax_f32).mean() < 1e-4


def test_bf16_artifact_within_twice_the_jax_bf16_gap(model, bf16_artifact, jax_f32):
    x = _images()
    got = export.load_serving(bf16_artifact[0], device="cpu").call(x)
    assert got.shape == (B, 4, H, W) and got.dtype == np.float32
    ref = jax_f32
    jax_bf16 = _jax_forward(model, x, "bfloat16")
    gap = np.abs(got - ref).mean(axis=(0, 2, 3))
    jax_gap = np.abs(jax_bf16 - ref).mean(axis=(0, 2, 3))
    assert (gap > 0).all(), "the bf16 artifact computed in f32"
    assert (gap <= 2 * jax_gap + 1e-3).all(), (gap, jax_gap)


def test_sidecar_equals_metadata(f32_artifact, bf16_artifact):
    for out, meta in (f32_artifact, bf16_artifact):
        with open(out + ".json") as f:
            side = json.load(f)
        assert side == meta and set(side) == META_KEYS
        assert side["bytes"] == os.path.getsize(out)
        assert side["platforms"] == ["cpu"] and side["torch_version"] == torch.__version__
        assert (side["height"], side["width"], side["batch"]) == (H, W, B)
        assert side["channels"] == export.CHANNEL_CONTRACT
    # the weights are in the program: bf16 holds half the bytes of f32
    assert 0.4 < bf16_artifact[1]["bytes"] / f32_artifact[1]["bytes"] < 0.6


def test_serving_model_pads_and_splits_odd_batches(f32_artifact):
    model = export.load_serving(f32_artifact[0], device="cpu")
    images = _images(2 * B + 1, seed=1)
    got = model.call(images)
    assert got.shape == (2 * B + 1, 4, H, W)
    # the padded slots do not leak into real outputs
    np.testing.assert_allclose(got[-1:], model.call(images[-1:]), atol=1e-5, rtol=1e-5)
    empty = model.call(images[:0])
    assert empty.shape == (0, 4, H, W) and empty.dtype == np.float32
    with pytest.raises(ValueError):
        model.call(images[:, : H // 2])


def test_load_without_sidecar_reads_the_program(f32_artifact, tmp_path):
    bare = tmp_path / "bare.pt2"
    bare.write_bytes(open(f32_artifact[0], "rb").read())
    model = export.load_serving(str(bare), device="cpu")
    assert (model.batch, model.height, model.width) == (B, H, W)
    assert model.meta["channels"] == export.CHANNEL_CONTRACT


def test_load_refuses_a_device_the_artifact_was_not_exported_for(f32_artifact, tmp_path):
    out, meta = f32_artifact
    copy = tmp_path / "cuda_only.pt2"
    copy.write_bytes(open(out, "rb").read())
    (tmp_path / "cuda_only.pt2.json").write_text(json.dumps({**meta, "platforms": ["cuda"]}))
    with pytest.raises(ValueError, match="exported for"):
        export.load_serving(str(copy), device="cpu")


def test_segmentor_artifact_matches_jax(tmp_path):
    seeded = Segmentor(DEPTH, True, generator=torch.Generator().manual_seed(4))
    params, state = segmentor_jax_params_from_state_dict(seeded.state_dict(), DEPTH, True)
    rng = np.random.RandomState(4)
    params, state = _randomise_bn(params, rng), _randomise_bn(state, rng)
    weights = str(tmp_path / "epoch_0.pth")
    torch.save(segmentor_state_dict_from_jax_params(params, state, DEPTH, True), weights)
    out = str(tmp_path / "seg.pt2")
    meta = export.export_serving(weights, out, height=H, width=W, batch=B,
                                 dtype="float32", platforms=("cpu",), depth=DEPTH,
                                 network="segmentor")
    assert meta["model"] == "Segmentor" and meta["use_psp"] is True
    x = _images()
    got = export.load_serving(out, device="cpu").call(x)
    assert got.shape == (B, H, W) and got.dtype == np.float16
    fn = jax_segmentor_forward(JaxSegmentor(DEPTH, True), params, state, "float32")
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    np.testing.assert_allclose(np.float32(got), np.float32(want), atol=1e-3)


def test_predict_simple_serves_from_artifact(tmp_path):
    """predict_simple's --model_path loads a FootprintNetwork-34."""
    weights = tmp_path / "weights34"
    weights.mkdir()
    net = FootprintNetwork(34, generator=torch.Generator().manual_seed(6))
    torch.save(net.state_dict(), str(weights / "model.pth"))
    artifact = str(tmp_path / "model34.pt2")
    export.export_serving(str(weights), artifact, height=H, width=W, batch=B,
                          dtype="float32", platforms=("cpu",), depth=34)
    d_art, d_live = str(tmp_path / "art"), str(tmp_path / "live")
    predict_simple.main(["--image", CYCLIST, "--artifact", artifact,
                         "--device", "cpu", "--save_dir", d_art, "--no_save_vis"])
    predict_simple.main(["--image", CYCLIST, "--model_path", str(weights),
                         "--height", str(H), "--width", str(W), "--device", "cpu",
                         "--save_dir", d_live, "--no_save_vis"])
    a = np.load(os.path.join(d_art, "outputs", "cyclist.npy"))
    b = np.load(os.path.join(d_live, "outputs", "cyclist.npy"))
    assert a.shape == (4, H, W)
    np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_predict_simple_artifact_resolution_conflict(f32_artifact, tmp_path):
    with pytest.raises(ValueError, match="conflict"):
        predict_simple.InferenceManager(None, str(tmp_path / "x"), artifact=f32_artifact[0],
                                        height=2 * H, width=W, device="cpu")


def test_export_cli_writes_both_files(model, tmp_path):
    out = str(tmp_path / "cli.pt2")
    export.main(["--model_path", model[0], "--out", out, "--height", str(H),
                 "--width", str(W), "--batch", "1", "--dtype", "float32",
                 "--platforms", "cpu", "--encoder_depth", str(DEPTH)])
    assert os.path.exists(out) and os.path.exists(out + ".json")
    with open(out + ".json") as f:
        assert json.load(f)["batch"] == 1


def test_entry_points_default_to_cuda_and_raise_without_it(model, f32_artifact, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.load_serving(f32_artifact[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.export_serving(model[0], str(tmp_path / "x.pt2"), height=H, width=W,
                              depth=DEPTH)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_simple.main(["--image", CYCLIST, "--artifact", f32_artifact[0],
                             "--save_dir", str(tmp_path), "--no_save_vis"])


def test_artifact_loads_with_no_model_code(f32_artifact):
    """A fresh process that imports only footprints_tpu_torch.export loads
    and runs the artifact; no model module is imported."""
    code = (
        "import sys, numpy as np\n"
        "from footprints_tpu_torch.export import load_serving\n"
        f"m = load_serving({f32_artifact[0]!r}, device='cpu')\n"
        f"y = m.call(np.zeros((1, {H}, {W}, 3), np.float32))\n"
        "assert y.shape == (1, 4, %d, %d) and np.isfinite(y).all()\n"
        "bad = sorted(k for k in sys.modules if k.startswith(\n"
        "    ('footprints_tpu_torch.models', 'footprints_tpu_torch.model_manager',\n"
        "     'footprints_tpu_torch.nn.blocks', 'jax', 'footprints_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n") % (H, W)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"


def test_exported_graph_hands_the_op_its_layouts(f32_artifact):
    """The program calls the kernel at the model's sites (kernel_sites), in
    order, and every call gets an NHWC-contiguous x and a weight with
    strides (s, 9, 3, 1): the post-concat conv1's two halves as
    input-channel slice views of their [Co, 2Ci, 3, 3] weight, every other
    weight whole."""
    program = torch.export.load(f32_artifact[0])
    calls = [n for n in program.graph.nodes
             if n.target is torch.ops.footprints.fused_conv3x3.default]
    sites = kernel_sites(FootprintNetwork(DEPTH, device="meta"), B, H, W)
    assert [tuple(node.args[0].meta["val"].shape) for node in calls] == [s[2] for s in sites]
    slices = collections.Counter()
    for node in calls:
        x, w = (a.meta["val"] for a in node.args[:2])
        assert x.is_contiguous() and x.dim() == 4
        assert w.stride()[1:] == (9, 3, 1) and w.stride(0) >= 9 * w.shape[1]
        if w.stride(0) == 9 * 2 * w.shape[1]:
            slices[w.shape[1]] += 1
    assert slices == collections.Counter(s[2][3] for s in sites if s[0].endswith("_half"))


@pytest.mark.parametrize("pad_mode", ["reflect", "up2_reflect"])
@pytest.mark.parametrize("with_res", [False, True])
def test_opcheck_cpu(pad_mode, with_res):
    """torch.library.opcheck on the CPU implementation: schema, fake
    implementation, registered autograd and its use under tracing."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 5, 6, 3, generator=g, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, generator=g, requires_grad=True)
    b = torch.randn(4, generator=g, requires_grad=True)
    ho, wo = (5, 6) if pad_mode == "reflect" else (10, 12)
    r = torch.randn(2, ho, wo, 4, generator=g, requires_grad=True) if with_res else None
    torch.library.opcheck(fc.fused_conv3x3_op, (x, w, b, r, pad_mode, "elu"))


def test_fake_implementation_counts_no_launch():
    """Tracing the op (export's fake tensors) launches nothing."""
    before = (fc.fused_conv3x3.launches, fc.fused_conv3x3.bf16_launches)

    class Site(torch.nn.Module):
        def forward(self, x, w):
            return fc.conv_reflect_fused(x, w, None, act="elu")

    program = torch.export.export(Site(), (torch.randn(1, 4, 4, 3),
                                           torch.randn(2, 3, 3, 3)))
    assert (fc.fused_conv3x3.launches, fc.fused_conv3x3.bf16_launches) == before
    assert any(n.target is torch.ops.footprints.fused_conv3x3.default
               for n in program.graph.nodes)
