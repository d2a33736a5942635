"""The share of requests served by a CUDA graph's replay, in %: of the
traced stretch's ``predict.forward`` spans (one a request), those inside
which a ``predict.graph.replay`` span ran.  A program that replays no
graph reads 0; a stretch with no ``predict.forward`` span reads nothing."""

import programspans


def read(m):
    forwards = programspans.in_stretch(m.trace, "predict.forward")
    if not forwards:
        return None
    replayed = {s.parent for s in programspans.in_stretch(m.trace, "predict.graph.replay")}
    return 100.0 * sum(f.id in replayed for f in forwards) / len(forwards)
