"""footprints_tpu_torch — the PyTorch/CUDA port of footprints_tpu.

The port serves and trains the FootprintNetwork (ResNet encoder + mask and
depth SkipDecoders) on an NVIDIA H100.  It mirrors the JAX package's module
names so each counterpart is easy to find, and it imports nothing of JAX or
of ``footprints_tpu``: an H100 host runs it with PyTorch, numpy and scipy
(the training data path also needs Pillow, OpenCV and PyYAML, imported where
used).

Layout:
    core/        numeric primitives, config/split files, depth-mask labels
    nn/          layers, initialisers, decoder blocks, ResNet encoders
    models/      FootprintNetwork
    ops/         the hand-written CUDA fused pad+conv3x3 kernel: wrapper,
                 autograd Function, plain PyTorch version, nvcc/ctypes build
    csrc/        CUDA sources (built for sm_90a at first use)
    data/        KITTI dataset, threaded loader, compact transport, device
                 prefetcher
    train/       losses, train/eval steps, evaluator, logger, TrainManager
    convert.py   JAX params/state pytrees <-> the port's state_dict, and
                 the JAX flat order of Adam's moments
    checkpoint.py  writer and reader of the JAX package's ``checkpoint.npz``
    model_manager.py  network, optimizer, save and load
    predict_simple.py  the one-shot prediction CLI
    main.py      ``--mode train`` entry point

Numerics: f32 is true f32.  Selecting a device through ``utils.select_device``
turns TF32 off for cuDNN convolutions and matmuls, so the port matches the
JAX package at precision "highest".
"""

__version__ = "0.1.0"
