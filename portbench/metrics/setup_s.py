"""Seconds from the process's start to the window's first request: imports,
the CUDA context, the data made on the card and loaded, kernel builds and
loads, and the warm-up on the cell's own traffic."""


def read(ctx):
    return ctx.setup_s
