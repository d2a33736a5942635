"""The caching allocator's peak over the window, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's start)."""


def read(m):
    return m.peak_window_bytes / 2**30 if m.peak_window_bytes else None
