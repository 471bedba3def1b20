"""Seconds from process start to the first timed step: imports, CUDA
initialisation, the kernel library (built on a cold cache), tables, states,
solver and warm-up."""


def read(ctx):
    return ctx.setup_s
