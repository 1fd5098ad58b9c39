"""Share of the store's certified queries whose certificate failed and
reran exactly (K1 over the whole store): the program's counters
``vectorstore.cert_misses`` over ``vectorstore.cert_queries``."""


def read(ctx):
    queries = ctx.counters.get("vectorstore.cert_queries", 0.0)
    return 100.0 * ctx.counters.get("vectorstore.cert_misses", 0.0) / queries if queries else None
