"""Training data: datasets, the threaded batch loader, the device
prefetcher and the compact host->device batch encoding (counterpart of
footprints_tpu/data/).  Nothing here imports PIL, cv2 or PyYAML at import
time."""

from .base import FootprintsDataset
from .kitti import KITTIDataset
from .loader import BackgroundWriter, DataLoader, DevicePrefetcher, collate

_DATASETS = {"kitti": KITTIDataset}
_NOT_PORTED = ("matterport",)


def get_dataset_class(name: str):
    """Training-dataset registry (reference: datasets/__init__.py:13-30)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"the {name} training dataset is not ported yet; it arrives with "
            "the batch-dump inference slice")
    try:
        return _DATASETS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; known: "
                       f"{sorted(_DATASETS) + list(_NOT_PORTED)}") from None


__all__ = ["BackgroundWriter", "DataLoader", "DevicePrefetcher",
           "FootprintsDataset", "KITTIDataset", "collate", "get_dataset_class"]
