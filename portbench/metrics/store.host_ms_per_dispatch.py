"""Host time of the store per dispatch, outside the wait for the device:
the query upload, the launches, any certificate rerun and the results'
materialisation (``vectorstore.py``'s spans): the program's counters
``vectorstore.host_s`` over ``vectorstore.dispatches``, in ms. None where
the program has no such counter."""


def read(ctx):
    host_s = ctx.counters.get("vectorstore.host_s")
    dispatches = ctx.counters.get("vectorstore.dispatches", 0.0)
    return 1000.0 * host_s / dispatches if host_s is not None and dispatches else None
