"""The share of the traced stretch, in %, in which the dump's background
writer was running a save: the union of its ``writer.write`` spans over the
stretch."""

import programspans


def read(m):
    spans = programspans.in_stretch(m.trace, "writer.write")
    if not spans or m.trace.window_s <= 0:
        return None
    return 100.0 * programspans.busy_s(spans) / m.trace.window_s
