"""Data: training and test-split datasets, the threaded batch loader, the
device prefetcher, the background writer and the compact host->device batch
encoding (counterpart of footprints_tpu/data/).  Nothing here imports PIL,
cv2 or PyYAML at import time."""

from .base import FootprintsDataset
from .inference import (InferenceDataset, KITTIInferenceDataset,
                        MatterportInferenceDataset)
from .kitti import KITTIDataset
from .loader import BackgroundWriter, DataLoader, DevicePrefetcher, collate
from .matterport import MatterportDataset

_DATASETS = {"kitti": KITTIDataset, "matterport": MatterportDataset}
_INFERENCE_DATASETS = {
    "kitti": KITTIInferenceDataset,
    "matterport": MatterportInferenceDataset,
}


def get_dataset_class(name: str):
    """Training-dataset registry (reference: datasets/__init__.py:13-30)."""
    try:
        return _DATASETS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(_DATASETS)}") from None


def get_inference_dataset_class(name: str):
    try:
        return _INFERENCE_DATASETS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; known: "
                       f"{sorted(_INFERENCE_DATASETS)}") from None


__all__ = ["BackgroundWriter", "DataLoader", "DevicePrefetcher", "FootprintsDataset",
           "InferenceDataset", "KITTIDataset", "KITTIInferenceDataset",
           "MatterportDataset", "MatterportInferenceDataset", "collate",
           "get_dataset_class", "get_inference_dataset_class"]
