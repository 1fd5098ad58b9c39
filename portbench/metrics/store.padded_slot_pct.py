"""Share of the query slots the store launched that carry no query: the
bucket padding of each request and the stacking of a coalesced dispatch
(``vectorstore.py``): the program's counters ``vectorstore.query_slots``
and ``vectorstore.queries``. None where the program has no such counter."""


def read(ctx):
    slots = ctx.counters.get("vectorstore.query_slots", 0.0)
    queries = ctx.counters.get("vectorstore.queries", 0.0)
    return 100.0 * (slots - queries) / slots if slots else None
