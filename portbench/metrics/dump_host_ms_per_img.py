"""The dump loop's serial host work, in ms an image: the host time of its
``dump.submit`` spans (pad, pin, upload, the forward and the copy back
queued) and ``dump.save`` spans (handing each batch to the writer) inside
the traced stretch, over the images the stretch dumped."""

import programspans


def read(m):
    spans = programspans.in_stretch(m.trace, "dump.submit", "dump.save")
    if not spans or not m.trace.units:
        return None
    return programspans.host_ms(spans) / m.trace.units
