"""The whole step's share of the card's peak, in %: the benchmark's FLOPs
of the work the window completed (a forward an image served or dumped;
forward, dgrad and wgrad an image stepped) over the window's time, against
the peak of the configuration's dtype (flops.PEAKS: f32 as 3xTF32)."""

import flops


def read(m):
    if m.window_s <= 0 or m.units == 0:
        return None
    rate = m.units * m.flops_per_unit / m.window_s
    return 100.0 * rate / flops.PEAKS[m.cell.config["dtype"]]
