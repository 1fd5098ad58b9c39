"""Rows an int8 corpus's row masks cover per search: the program's
counters ``corpus.rowmask_rows`` (each mask's length, the shard's whole
capacity however small the scope; ``parallel/sharded.py``) over
``corpus.searches``. None where the program has no such counter."""


def read(ctx):
    rows = ctx.counters.get("corpus.rowmask_rows")
    searches = ctx.counters.get("corpus.searches", 0.0)
    return rows / searches if rows is not None and searches else None
