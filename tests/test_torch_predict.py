"""The port's predict_simple CLI on the CPU, held against the JAX forward on
the same preprocessed image, plus the port's device policy and its import
isolation from JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from footprints_tpu.convert import (footprint_params_from_state_dict,
                                    load_torch_state_dict)
from footprints_tpu.models import FootprintNetwork as JaxFootprintNetwork
from footprints_tpu_torch import predict_simple, utils
from footprints_tpu_torch.model_manager import ModelManager
from footprints_tpu_torch.models import FootprintNetwork

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CYCLIST = os.path.join(REPO, "test_data", "cyclist.jpg")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    folder = tmp_path_factory.mktemp("weights")
    net = FootprintNetwork(34, generator=torch.Generator().manual_seed(10))
    torch.save(net.state_dict(), str(folder / "model.pth"))
    return str(folder)


def _run(weights, out, *extra):
    predict_simple.main(["--image", extra[0], "--model_path", weights,
                         "--device", "cpu", "--save_dir", str(out), *extra[1:]])


def test_predict_cpu_matches_jax_forward(weights, tmp_path):
    _run(weights, tmp_path, CYCLIST, "--no_save_vis")
    got = np.load(tmp_path / "outputs" / "cyclist.npy")
    assert got.shape == (4, 192, 640) and got.dtype == np.float32
    assert not (tmp_path / "visualisations").exists()

    from PIL import Image

    img = Image.open(CYCLIST).convert("RGB").resize((640, 192), Image.LANCZOS)
    x = (np.asarray(img, np.float32) / 255.0)[None]
    params, state = footprint_params_from_state_dict(
        load_torch_state_dict(os.path.join(weights, "model.pth")))
    out, _ = JaxFootprintNetwork(34).apply(params, state, jnp.asarray(x),
                                           train=False)
    ref = np.transpose(np.asarray(out["1/1"])[0], (2, 0, 1))
    assert np.abs(got - ref).mean() < 1e-4
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_folder_mode_with_visualisations(weights, tmp_path):
    _run(weights, tmp_path, os.path.join(REPO, "test_data"),
         "--height", "64", "--width", "128")
    names = sorted(os.listdir(tmp_path / "outputs"))
    assert names == ["chinatown.npy", "cyclist.npy", "lobby.npy"]
    for name in names:
        pred = np.load(tmp_path / "outputs" / name)
        assert pred.shape == (4, 64, 128) and np.isfinite(pred).all()
    assert sorted(os.listdir(tmp_path / "visualisations")) == [
        "chinatown.jpg", "cyclist.jpg", "lobby.jpg"]


def test_apply_sigmoid_touches_only_the_mask_channels(weights, tmp_path):
    small = ("--height", "64", "--width", "128", "--no_save_vis")
    _run(weights, tmp_path / "raw", CYCLIST, *small)
    _run(weights, tmp_path / "sig", CYCLIST, "--apply_sigmoid", *small)
    raw = np.load(tmp_path / "raw" / "outputs" / "cyclist.npy")
    sig = np.load(tmp_path / "sig" / "outputs" / "cyclist.npy")
    np.testing.assert_allclose(sig[:2], 1 / (1 + np.exp(-raw[:2])), rtol=1e-6)
    np.testing.assert_array_equal(sig[2:], raw[2:])


def test_default_device_is_cuda_and_raises_without_it(weights, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        predict_simple.main(["--image", CYCLIST, "--model_path", weights,
                             "--save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelManager()


def test_artifact_is_not_ported_yet(weights, tmp_path):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        predict_simple.main(["--image", CYCLIST, "--artifact", "x",
                             "--device", "cpu", "--save_dir", str(tmp_path)])


def test_select_device_turns_tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert utils.select_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(ValueError):
        utils.select_device("meta")


_IMPORT_ALL = (
    "import pkgutil, importlib, sys\n"
    "import footprints_tpu_torch as pkg\n"
    "import footprints_tpu_torch.main, footprints_tpu_torch.train.trainer\n"
    "import footprints_tpu_torch.data, footprints_tpu_torch.data.compact\n"
    "import footprints_tpu_torch.eval.inference, footprints_tpu_torch.eval.evaluate_model\n"
    "import footprints_tpu_torch.models.segmentor\n"
    "import footprints_tpu_torch.preprocessing.segmentation.main\n"
    "import footprints_tpu_torch.preprocessing.segmentation.inference\n"
    "import footprints_tpu_torch.preprocessing.segmentation.trainer\n"
    "import footprints_tpu_torch.preprocessing.segmentation.losses\n"
    "import footprints_tpu_torch.convert.bridge, footprints_tpu_torch.convert.cli\n"
    "import footprints_tpu_torch.convert.torchvision_resnet\n"
    "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
    "    importlib.import_module(m.name)\n"
    "import chip_smoke\n"
)


def _run_python(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_port_imports_neither_jax_nor_the_jax_package():
    """Nor, at import, the optional packages of the data path, the dumps,
    the harness and the logger (PIL, cv2, PyYAML, matplotlib,
    tensorboardX), which a card host may lack."""
    code = _IMPORT_ALL + (
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'optax', 'footprints_tpu'))\n"
        "assert not bad, bad\n"
        "lazy = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "              ('PIL', 'cv2', 'yaml', 'matplotlib', 'tensorboardX'))\n"
        "assert not lazy, lazy\n"
        "print(len([k for k in sys.modules if k.startswith('footprints_tpu_torch')]))\n"
    )
    assert int(_run_python(code).strip().splitlines()[-1]) >= 45


def test_port_imports_with_the_optional_packages_blocked():
    """A host without PIL, OpenCV, matplotlib or PyYAML (an import of them
    raises ImportError) still imports every module and chip_smoke.py."""
    code = ("import sys\n"
            "for name in ('PIL', 'cv2', 'matplotlib', 'yaml'):\n"
            "    sys.modules[name] = None\n") + _IMPORT_ALL + (
        "try:\n"
        "    import PIL\n"
        "except ImportError:\n"
        "    print('blocked')\n")
    assert _run_python(code).strip().splitlines()[-1] == "blocked"
