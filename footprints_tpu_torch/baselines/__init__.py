"""Classical footprint baselines on the host, numpy and OpenCV
(counterpart of footprints_tpu/baselines/)."""
