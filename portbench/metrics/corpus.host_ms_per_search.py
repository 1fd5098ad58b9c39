"""Host time of the corpus per search, outside the wait for the device:
normalising, the scope's name set and interval table, the uploads and
launches, and resolving each hit to its conversation
(``parallel/corpus.py``, ``parallel/sharded.py``): the program's counters
``corpus.host_s`` over ``corpus.searches``, in ms. None where the program
has no such counter."""


def read(ctx):
    host_s = ctx.counters.get("corpus.host_s")
    searches = ctx.counters.get("corpus.searches", 0.0)
    return 1000.0 * host_s / searches if host_s is not None and searches else None
