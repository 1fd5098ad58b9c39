"""Requests per device dispatch of the serving front (``serve.py``'s
``LookupBatcher``): the program's counters ``serve.requests`` and
``serve.dispatches`` over the window."""


def read(ctx):
    dispatches = ctx.counters.get("serve.dispatches", 0.0)
    return ctx.counters.get("serve.requests", 0.0) / dispatches if dispatches else None
