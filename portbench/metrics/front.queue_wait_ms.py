"""Mean wait of a request in the serving front's queue (``serve.py``'s
``LookupBatcher``), from enqueue until its group is taken for a dispatch:
the program's counters ``serve.queue_wait_s`` over ``serve.requests``, in
ms. None where the program has no such counter."""


def read(ctx):
    wait_s = ctx.counters.get("serve.queue_wait_s")
    requests = ctx.counters.get("serve.requests", 0.0)
    return 1000.0 * wait_s / requests if wait_s is not None and requests else None
