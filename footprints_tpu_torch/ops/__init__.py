"""Hand-written CUDA kernels and their wrappers (counterpart of
footprints_tpu/ops/).  Nothing here builds or loads a kernel at import:
``build.load_library`` runs at the first launch."""

from .fused_conv import (conv_reflect_fused, conv_reflect_res_fused, fused_conv3x3,
                         fused_conv3x3_dgrad, fused_conv3x3_dgrad_plain, fused_conv3x3_plain,
                         fused_conv3x3_wgrad, fused_conv3x3_wgrad_plain, up_conv_fused)

__all__ = ["conv_reflect_fused", "conv_reflect_res_fused", "fused_conv3x3",
           "fused_conv3x3_dgrad", "fused_conv3x3_dgrad_plain", "fused_conv3x3_plain",
           "fused_conv3x3_wgrad", "fused_conv3x3_wgrad_plain", "up_conv_fused"]
