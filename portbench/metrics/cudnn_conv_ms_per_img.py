"""cuDNN's convolutions (the encoder's and the decoders' convs that the
fused kernel does not run, forward and backward), in ms an image: the
union of the intervals of the traced kernels in devtrace's 'cudnn conv'
bucket, over the images the traced stretch computed."""

import devtrace


def read(m):
    if m.trace is None:
        return None
    spans = devtrace.category_spans(m.trace, {"cudnn conv"})
    return m.trace.busy_s(spans) * 1e3 / m.trace.units if spans else None
