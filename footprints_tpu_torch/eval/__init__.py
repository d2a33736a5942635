"""Batch test-split inference and the offline metric harness (counterpart
of footprints_tpu/eval/)."""

from .evaluate_model import evaluate, evaluate_depth, evaluate_mask

__all__ = ["evaluate", "evaluate_depth", "evaluate_mask"]
