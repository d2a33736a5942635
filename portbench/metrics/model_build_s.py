"""Construction of the program's model, in s: the host seconds of its
``model.build`` spans in the run's process (meta construction, the move to
the device and the initial draws), which set-up pays before the weights
load."""

import programspans


def read(m):
    total = programspans.total("model.build")
    return total.seconds if total else None
