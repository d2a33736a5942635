"""Geometric ground-truth generation on the card (counterpart of
footprints_tpu/preprocessing/ground_truth_generation/): hidden depths,
depth masks and moving-object masks for KITTI and Matterport, through
``generator.py``'s CLI."""
