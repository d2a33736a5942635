"""The host's time to launch one request, in ms: the mean host time of the
``predict.forward`` spans (the upload and the eager forward, queued) of the
traced stretch, one a request."""

import programspans


def read(m):
    spans = programspans.in_stretch(m.trace, "predict.forward")
    return programspans.host_ms(spans) / len(spans) if spans else None
