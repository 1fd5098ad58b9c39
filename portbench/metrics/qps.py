"""Queries answered inside the window per second of the window."""


def read(ctx):
    w = ctx.window
    answered = sum(d.n for d in w.done if d.error is None and d.done_ns <= w.stop_ns)
    return answered / w.seconds
