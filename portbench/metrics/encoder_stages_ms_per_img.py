"""The encoder's residual stages on the device, in ms an image: the time
between the CUDA events of each ``encoder.layer1`` ... ``encoder.layer4``
span of the traced stretch (one a stage a forward), summed, over its
images.  Nothing where the program records no such span."""

import programspans

STAGES = tuple(f"encoder.layer{i}" for i in range(1, 5))


def read(m):
    spans = programspans.in_stretch(m.trace, *STAGES)
    if not spans or not m.trace.units or any(s.device_ms is None for s in spans):
        return None
    return sum(s.device_ms for s in spans) / m.trace.units
