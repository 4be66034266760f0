"""The allocator's peak of device memory in the window, in GB (10^9 bytes):
``torch.cuda.max_memory_allocated()`` after a reset at the window's start."""


def read(ctx):
    return ctx.peak_window_bytes / 1e9 if ctx.peak_window_bytes else None
