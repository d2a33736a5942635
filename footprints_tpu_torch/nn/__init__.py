"""Layers, initialisers, decoder blocks and ResNet encoders.  Submodules are
imported by name (``from footprints_tpu_torch.nn import blocks``): ``blocks``
depends on ``ops.fused_conv``, which depends on ``layers``."""
