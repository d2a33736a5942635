"""The decoders' post-concat ConvBlocks on the device, in ms an image: the
convs that the encoder's skips feed.  The time between the CUDA events of
each ``decoder.post_concat`` span of the traced stretch (one a decoder
block a forward, on the fused kernel or on cuDNN), summed, over its
images.  Nothing where the program records no such span."""

import programspans


def read(m):
    return programspans.device_ms_per_unit(m.trace, "decoder.post_concat")
