"""Shared utilities: device selection, image loading, visualisation
scaling, time formatting and the md5-checked download of the published
checkpoints (counterpart of footprints_tpu/utils.py).  PIL is imported only
inside ``pil_loader``."""

import hashlib
import os
import urllib.request
import zipfile

import numpy as np
import torch

MODEL_DIR = "models"

# (<google cloud URL>, <md5>) — the reference's published artifacts
MODEL_DOWNLOADS = {
    "kitti": (
        "https://storage.googleapis.com/niantic-lon-static/research/footprints/kitti.zip",
        "a52e3b04bffd86f62c62cf8859c47798"),
    "matterport": (
        "https://storage.googleapis.com/niantic-lon-static/research/footprints/matterport.zip",
        "e28929d0819392d2178c880725531c4e"),
    "handheld": (
        "https://storage.googleapis.com/niantic-lon-static/research/footprints/handheld.zip",
        "ab97945cf8f8f9e8d9bdedf8961506b6"),
}


def select_device(device="cuda"):
    """Resolve ``device`` and fix the f32 policy: TF32 off for cuDNN
    convolutions and for matmuls, so f32 is true f32.  Raises when CUDA is
    asked for and absent; there is no fallback to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def pil_loader(path):
    from PIL import Image

    with open(path, "rb") as f:
        with Image.open(f) as img:
            return img.convert("RGB")


def normalise_image(img):
    """Min-max normalise a numpy image to [0, 1] for visualisation."""
    img = np.asarray(img, dtype=np.float32)
    lo, hi = float(img.min()), float(img.max())
    denom = hi - lo if hi != lo else 1e5
    return (img - lo) / denom


def sec_to_hm_str(secs):
    """Seconds -> '00h00m00s'."""
    secs = int(secs)
    return f"{secs // 3600:02d}h{(secs // 60) % 60:02d}m{secs % 60:02d}s"


def check_file_matches_md5(checksum, fpath):
    if not os.path.exists(fpath):
        return False
    with open(fpath, "rb") as f:
        return hashlib.md5(f.read()).hexdigest() == checksum


def download_model_if_doesnt_exist(model_name, model_dir=MODEL_DIR):
    """Fetch and unzip a pretrained reference checkpoint (md5-verified)."""
    os.makedirs(model_dir, exist_ok=True)
    model_path = os.path.join(model_dir, model_name)
    if os.path.exists(os.path.join(model_path, "model.pth")):
        return model_path
    url, md5 = MODEL_DOWNLOADS[model_name]
    zip_path = model_path + ".zip"
    if not check_file_matches_md5(md5, zip_path):
        print(f"Downloading {url} -> {zip_path}")
        urllib.request.urlretrieve(url, zip_path)
    if not check_file_matches_md5(md5, zip_path):
        raise RuntimeError(f"md5 mismatch for {zip_path} — aborting")
    with zipfile.ZipFile(zip_path) as f:
        f.extractall(model_path)
    return model_path
