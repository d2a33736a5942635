"""Device kernels launched a request (copies and memsets left out), from
the traced stretch: what the host has to issue for each image."""


def read(m):
    if m.trace is None or m.trace.units == 0:
        return None
    return len(m.trace.kernels()) / m.trace.units
