"""Seconds a slice's ray geometry takes: the port's ``raytrace.device_geometry``
stage (``delay/engine.py::_slice_geometry``), summed over the window's calls
and divided by them. The stage ends in host reads of device values, so it
also waits for work queued before it (the previous slice's integrate)."""


def read(ctx):
    row = ctx.stages.get('raytrace.device_geometry')
    return row['total_s'] / row['calls'] if row and row['calls'] else None
