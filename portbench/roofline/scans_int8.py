"""Roofline shares of an int8 store's scans (K6, K7).

Each search of the ``corpus_sync`` entry over an int8 corpus launches one
scan: K6 over every live row, or K7 over a scope's rows through its row
mask. Each launch is given the least bound among the stretch's requests of
its kind, as ``scans.py`` rules for the f32 scans, counted by
``counts.scan_int8`` for each request's real batch.
"""

from __future__ import annotations

from . import counts


def scan_int8_roofline(ctx, label: str) -> float | None:
    """Percent of the bound that ``label``'s launches (``"K6"`` or
    ``"K7"``) reach, or None when the stretch holds none of them or no
    request of their kind."""
    if ctx.trace is None:
        return None
    launches = [e for e in ctx.trace.events if e.label == label]
    masked = label == "K7"
    requests = [r for r in ctx.stretch_requests if (r.scope is not None) == masked]
    if not launches or not requests:
        return None
    peak = counts.peaks()
    dim, k = ctx.cell.cfg["dim"], ctx.cell.mix["k"]
    bound = min(
        counts.scan_int8(r.queries.shape[0], ctx.scope_rows(r.scope), dim, k,
                         mask=masked).bound_s(peak)
        for r in requests
    )
    seconds = sum(e.dur_ns for e in launches) * 1e-9
    return 100.0 * bound * len(launches) / seconds
