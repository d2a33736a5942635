"""footprints_tpu_torch — the PyTorch/CUDA port of footprints_tpu.

The port serves and trains the FootprintNetwork (ResNet encoder + mask and
depth SkipDecoders; f32, or bf16 mixed precision with the packed heads),
exports either model's serving forward in bf16 or f32 and serves it,
dumps test splits and scores them, and trains the Segmentor and runs its
ground_seg dump, on an NVIDIA H100.  It mirrors the JAX
package's module names so each counterpart is easy to find, and it imports
nothing of JAX or of ``footprints_tpu``: an H100 host runs it with PyTorch,
numpy and scipy (the data paths also need Pillow, OpenCV and PyYAML,
imported where used).

Layout:
    core/        numeric primitives, config/split files, depth-mask labels
    nn/          layers, initialisers, decoder blocks, ResNet encoders
    models/      FootprintNetwork, Segmentor
    ops/         the hand-written CUDA fused pad+conv3x3 kernel: the custom
                 op footprints::fused_conv3x3 (its CUDA, CPU, fake and
                 autograd implementations), wrappers, plain PyTorch
                 version, nvcc/ctypes build
    csrc/        CUDA sources (built for sm_90a at first use)
    data/        KITTI and Matterport datasets (training and test split),
                 threaded loader, compact transport, device prefetcher,
                 background writer
    train/       losses, train/eval steps, evaluator, logger, TrainManager
    eval/        the batch dump (InferenceManager) and the metric harness
    preprocessing/segmentation/  the ground_seg dump (Tester, CLI)
    convert/     JAX params/state pytrees <-> the port's state_dict (both
                 models), the JAX flat order of Adam's moments, the
                 --pretrained_encoder reader and the .pth -> npz CLI
    checkpoint.py  writer and reader of the JAX package's ``checkpoint.npz``
    model_manager.py  network, optimizer, save and load
    telemetry.py the spans at the layer boundaries: totals always, and
                 while a torch.profiler session runs, profiler events, a
                 ring on the profiler's clock and CUDA timing events
    predict_simple.py  the one-shot prediction CLI (a checkpoint, or
                 --artifact: a program that export.py wrote)
    export.py    the serving export: torch.export of the bf16 or f32
                 serving forward of either model, save, load, serve
    native/      ctypes binding of the repo's native/fp_image.cpp LANCZOS
                 resampler, built with g++ at first use
    main.py      ``--mode train`` and ``--mode inference`` entry point

Numerics: f32 is true f32.  Selecting a device through ``utils.select_device``
turns TF32 off for cuDNN convolutions and matmuls, so the port matches the
JAX package at precision "highest".
"""

__version__ = "0.1.0"
