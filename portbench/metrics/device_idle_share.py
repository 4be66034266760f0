"""Percent of the traced requests' wall time in which no operation ran on the
device: 1 - (union of the trace's device intervals) / (traced span)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t['busy_s'] / t['window_s']) if t else None
