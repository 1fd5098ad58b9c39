"""The comparison that decides ``correct``.

Each checked query's answers are held to the reference (``reference.py``)
by three numbers, each with a limit from the configuration file:

- ``score_err``: the widest gap between a returned score and the
  reference's score of the same row;
- ``rank_gap``: the widest gap by which the j-th best returned row's
  reference score lies below the reference's j-th best score in scope;
- ``bad_hits``: hits that are missing (fewer than the rows in scope
  above ``min_score`` allow), repeated, out of scope or out of range,
  below ``min_score``, or whose conversation and local ordinal are not
  the layout's. Its limit is 0.

Rows whose reference score lies within ``margin`` (the ``score_err``
limit) of ``min_score`` may be returned or cut.
"""

from __future__ import annotations

import numpy as np

from .reference import Answers

NUMBERS = ("score_err", "rank_gap", "bad_hits")


def judge(
    ans: Answers, items: np.ndarray, scores: np.ndarray, resolved: np.ndarray | None = None,
    min_score: float = 0.0, margin: float = 0.0,
) -> dict[str, float]:
    """The numbers for answers ``items`` ([m, k] rows, -1 where no hit) with
    their ``scores`` ([m, k], nan where no hit); ``resolved`` ([m, k] bool)
    says whether each hit's conversation and local ordinal are right."""
    items = np.asarray(items, dtype=np.int64)
    scores = np.asarray(scores, dtype=np.float64)
    ref = ans.item_ref.astype(np.float64)
    valid = items >= 0
    known = valid & np.isfinite(ref)
    err = np.abs(scores - ref)[known]
    good = known & ans.in_scope
    ref_sorted = -np.sort(-np.where(good, ref, -np.inf), axis=1)
    expected = np.isfinite(ans.best) & (ans.best >= min_score + margin)
    both = expected & np.isfinite(ref_sorted)
    gaps = ans.best.astype(np.float64)[both] - ref_sorted[both]
    repeated = sum(
        int(row[ok].size - np.unique(row[ok]).size) for row, ok in zip(items, valid)
    )
    detail = {
        "missing": int((expected & ~np.isfinite(ref_sorted)).sum()),
        "out_of_scope": int((valid & ~good).sum()),
        "repeated": repeated,
        "below_min_score": int((known & (ref < min_score - margin)).sum()),
        "unresolved": 0 if resolved is None else int((valid & ~resolved).sum()),
    }
    return {
        "score_err": float(err.max()) if err.size else 0.0,
        "rank_gap": float(max(gaps.max(), 0.0)) if gaps.size else 0.0,
        "bad_hits": float(sum(detail.values())),
        "detail": detail,
    }


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` for the compared numbers."""
    table = {name: {"value": numbers[name], "limit": limits[name]} for name in NUMBERS}
    return all(v["value"] <= v["limit"] for v in table.values()), table
