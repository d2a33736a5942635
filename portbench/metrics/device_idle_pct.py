"""The share of the traced stretch, in %, in which no operation ran on the
device: 1 minus the union of the device intervals over the stretch."""


def read(m):
    if m.trace is None or m.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - m.trace.busy_s() / m.trace.window_s)
