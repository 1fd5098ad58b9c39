"""Roofline shares of the scans a synchronous caller drives (K1, K4, K5).

Each search of the ``corpus_sync`` entry launches one scan: K1 for the
whole matrix, K4 or K5 for a scope. Every launch of a kernel in the
traced stretch is given the least bound among the stretch's requests of
its kind, so that a launch the profiler missed or a mix of unlike
requests never overstates the share; in a mix whose requests are alike,
as every cell's is, that is each launch's own bound.
"""

from __future__ import annotations

from . import counts


def scan_roofline(ctx, label: str) -> float | None:
    """Percent of the bound that ``label``'s launches reach, or None when
    the stretch holds none of them or no request of their kind."""
    if ctx.trace is None:
        return None
    launches = [e for e in ctx.trace.events if e.label == label]
    requests = [r for r in ctx.stretch_requests if (r.scope is None) == (label == "K1")]
    if not launches or not requests:
        return None
    peak = counts.peaks()
    dim, k = ctx.cell.cfg["dim"], ctx.cell.mix["k"]
    bound = min(
        counts.scan_f32(r.queries.shape[0], ctx.scope_rows(r.scope), dim, k,
                        mask=label == "K5").bound_s(peak)
        for r in requests
    )
    seconds = sum(e.dur_ns for e in launches) * 1e-9
    return 100.0 * bound * len(launches) / seconds
