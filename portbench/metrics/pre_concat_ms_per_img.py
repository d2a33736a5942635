"""The decoders' pre-concat ConvBlocks on the device, in ms an image: the
convs that take the deeper feature down to the block's width before the
upsample (block1's over the encoder's last feature, or the PSP's concat).
The time between the CUDA events of each ``decoder.pre_concat`` span of
the traced stretch (one a decoder block a forward, on the fused kernel or
on cuDNN), summed, over its images.  Nothing where the program records no
such span."""

import programspans


def read(m):
    return programspans.device_ms_per_unit(m.trace, "decoder.pre_concat")
