"""footprints_tpu_torch — the PyTorch/CUDA port of footprints_tpu.

The port serves the FootprintNetwork (ResNet encoder + mask and depth
SkipDecoders) on an NVIDIA H100.  It mirrors the JAX package's module names
so each counterpart is easy to find, and it imports nothing of JAX or of
``footprints_tpu``: an H100 host runs it with PyTorch and numpy alone.

Layout:
    core/        numeric primitives (sigmoid-disparity -> depth)
    nn/          layers, initialisers, decoder blocks, ResNet encoders
    models/      FootprintNetwork
    ops/         the hand-written CUDA fused pad+conv3x3 kernel: wrapper,
                 plain PyTorch version and the nvcc/ctypes build
    csrc/        CUDA sources (built for sm_90a at first use)
    convert.py   JAX params/state pytrees -> the port's state_dict
    checkpoint.py  reader of the JAX package's flat ``checkpoint.npz``
    model_manager.py  inference-only network loading
    predict_simple.py  the one-shot prediction CLI

Numerics: f32 is true f32.  Selecting a device through ``utils.select_device``
turns TF32 off for cuDNN convolutions and matmuls, so the port matches the
JAX package at precision "highest".
"""

__version__ = "0.1.0"
