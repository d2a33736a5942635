"""The decoders' device time, in ms an image: the time between the CUDA
events of each ``decoder`` span (every decoder of every forward; the PSP
inside the Segmentor's) in the traced stretch, summed, over its images."""

import programspans


def read(m):
    return programspans.device_ms_per_unit(m.trace, "decoder")
