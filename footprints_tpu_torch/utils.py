"""Shared utilities: device selection, image loading, visualisation
scaling, time formatting and the md5-checked download of the published
checkpoints and ground truths (counterpart of footprints_tpu/utils.py).  PIL
is imported only inside ``pil_loader``."""

import hashlib
import os
import urllib.request
import zipfile

import numpy as np
import torch

MODEL_DIR = "models"
GROUND_TRUTH_DIR = "ground_truth_files"

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
GROUND_TRUTH_DOWNLOADS = {
    "kitti": (
        "https://storage.googleapis.com/niantic-lon-static/research/footprints/data/kitti/kitti_ground_truth.zip",
        "1e25ee18016a9a4a939219fcc56f6eba"),
    "matterport": (
        "https://storage.googleapis.com/niantic-lon-static/research/footprints/data/matterport/matterport_ground_truth.zip",
        "eb9e0f8a04e35ddd8aa3eda9079c6b17"),
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


def _download_and_unzip(url, md5, zip_path, extract_to):
    if not check_file_matches_md5(md5, zip_path):
        print(f"Downloading {url} -> {zip_path}")
        urllib.request.urlretrieve(url, zip_path)
    if not check_file_matches_md5(md5, zip_path):
        raise RuntimeError(f"md5 mismatch for {zip_path} — aborting")
    with zipfile.ZipFile(zip_path) as f:
        f.extractall(extract_to)


def download_model_if_doesnt_exist(model_name, model_dir=MODEL_DIR):
    """Fetch and unzip a pretrained reference checkpoint (md5-verified)."""
    os.makedirs(model_dir, exist_ok=True)
    model_path = os.path.join(model_dir, model_name)
    if os.path.exists(os.path.join(model_path, "model.pth")):
        return model_path
    url, md5 = MODEL_DOWNLOADS[model_name]
    _download_and_unzip(url, md5, model_path + ".zip", model_path)
    return model_path


def download_ground_truths_if_dont_exist(dataset_name, gt_dir=GROUND_TRUTH_DIR):
    """Fetch and unzip a dataset's evaluation ground truth (md5-verified)
    unless ``<gt_dir>/<name>_ground_truth/<name>_ground_truth`` already
    holds more than 500 files."""
    os.makedirs(gt_dir, exist_ok=True)
    gt_path = os.path.join(gt_dir, f"{dataset_name}_ground_truth")
    os.makedirs(gt_path, exist_ok=True)
    subdir = os.path.join(gt_path, f"{dataset_name}_ground_truth")
    if os.path.exists(subdir) and len(os.listdir(subdir)) > 500:
        return gt_path
    url, md5 = GROUND_TRUTH_DOWNLOADS[dataset_name]
    _download_and_unzip(url, md5, gt_path + ".zip", gt_path)
    return gt_path
