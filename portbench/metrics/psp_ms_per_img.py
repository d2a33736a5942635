"""The Segmentor's PSP on the device, in ms an image: its four pools, 1x1
reduces, bilinear resizes and the concat.  The time between the CUDA
events of each ``decoder.psp`` span of the traced stretch (one a
forward), summed, over its images.  Nothing where the program records no
such span."""

import programspans


def read(m):
    return programspans.device_ms_per_unit(m.trace, "decoder.psp")
