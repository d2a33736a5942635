"""Preprocessing pipelines (counterpart of footprints_tpu/preprocessing/):
the ground segmentation that writes the ``ground_seg`` tree."""
