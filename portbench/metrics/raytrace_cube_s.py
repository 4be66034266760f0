"""Seconds a raytraced request's cube takes: the port's ``delay.raytrace_cube``
stage (``delay/engine.py::_build_cube_ray``: fields to the device, table,
geometry and integrate of every slice, the fetch to the host), summed over
the window's requests and divided by them."""


def read(ctx):
    row = ctx.stages.get('delay.raytrace_cube')
    return row['total_s'] / row['calls'] if row and row['calls'] else None
