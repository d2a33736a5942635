"""The train step's backward on the device, in ms an image: the time
between the CUDA events of each ``step.backward`` span of the traced
stretch, summed, over the images stepped."""

import programspans


def read(m):
    return programspans.device_ms_per_unit(m.trace, "step.backward")
