"""Seconds from the start of the run to the start of the window (host clock):
imports, CUDA start, the kernels' build or load, the seeded fields, the
models' processing and one request."""


def read(ctx):
    return ctx.setup_s
