"""Device posting-list engine: CSR term postings and fused score accumulation.

The port of ``typeagent_tpu/ops/postings.py``, as torch ops on an explicit
device: the index's, which is the conversation's ``settings.device``.
Secondary structured indexes become device CSR posting lists (term id ->
offsets, semref ids, scores), so that a compiled query's term matching,
scope masking and score accumulation run as one device program in place of
the host VM's per-term dict loops (reference ``knowpro/query.py:174-206,
446-489``).

Accumulation follows ``MatchAccumulator`` (``collections.py:73-106,
222-245``), rule by rule:

* exact ops add score x weight and one hit;
* a related op counts for a semref only where no earlier op of its leaf
  (by op position, in VM order) added it (``add_term_matches_if_new``);
* ``dedup_related`` counts a duplicate (op, semref) posting once;
* boost membership (OP_BOOST ops: entity name/type postings) multiplies
  the leaf's contributions to that semref by ``boost_factor``;
* per-op knowledge-type gates and scope rows filter scoring entries;
* ``op_hit`` says which ops had at least one in-scope posting;
* sums are f32, and results come in ascending (segment, semref) order.

One sorted core serves every public form. The ops' posting lists are
flattened ragged (the entry count is the total of the postings the call
reads), each live entry gets one int64 key

    ((segment * (semref_cap + 1) + semref) << 33) | op position

(boost entries carry the largest position, so they sort after every
scoring entry of their run), and one stable ``torch.sort`` lines the runs
up: a run is one (segment, semref). The first entry of a run holds its
least position (the first adder); each run is summed by
``torch.segment_reduce`` in that sorted order, one run by one thread, so
a call gives the same bits every time it runs (an atomic float
``index_add_`` on CUDA adds in an order that changes from run to run, and
a flipped tie at a top-N cut changes an answer). The dense, compact and
COO forms and the single-scope ``accumulate_postings`` lay those run sums
out as their JAX namesakes do, at their shapes.

Where the JAX package pads shapes to buckets for XLA and packs its sort
key into int32 (x64 is off on a TPU), the port sizes each call from what
it holds: no padding, no retry over result buckets. The key's high 30
bits hold the run, the bound the JAX key has too, so one call keys at
most 2**30 (segment, semref) slots (:data:`_RUN_KEYS`); its low 33 bits
the op position (:data:`_POS_P`), past any real leaf's width.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..native import create_interner
from .append import round_up

__all__ = [
    "DevicePostingsIndex",
    "OP_BOOST",
    "OP_EXACT",
    "OP_RELATED",
    "accumulate_postings",
    "accumulate_postings_segmented",
    "accumulate_postings_segmented_compact",
    "accumulate_postings_segmented_coo",
]

# Op kinds for the segmented accumulator.
OP_EXACT = 0
OP_RELATED = 1
OP_BOOST = 2  # membership-only entries for the entity-boost mask

_POS_BITS = 33
_POS_P = 1 << _POS_BITS  # positions < _POS_P - 1; boost entries carry _POS_P - 1
_RUN_KEYS = 1 << 30  # (segment, semref) slots one call can key
_DEAD_KEY = _RUN_KEYS  # the COO form's padding key, as in the JAX package

class _Runs(NamedTuple):
    """One call's accumulation, run by run."""

    keys: torch.Tensor  # [n_runs] i64: segment * (semref_cap + 1) + semref, ascending
    sums: torch.Tensor  # [4, n_runs] f32: exact score, exact hits, related score, related hits
    op_hit: torch.Tensor  # [t] bool


def _accumulate_runs(
    offsets: torch.Tensor,  # [terms + 1] i64 CSR offsets
    post_semrefs: torch.Tensor,  # [postings] i32
    post_scores: torch.Tensor,  # [postings] f32
    tids: torch.Tensor,  # [t] query term ids (-1 = none)
    weights: torch.Tensor,  # [t] f32 per-op weight
    segs: torch.Tensor,  # [t] leaf segment per op
    kinds: torch.Tensor,  # [t] OP_EXACT / OP_RELATED / OP_BOOST
    positions: torch.Tensor,  # [t] op position within its leaf (VM order)
    ktype_gate: torch.Tensor | None,  # [t] -1 or the knowledge type required
    scope_ids: torch.Tensor | None,  # [t] row of scope_masks per op
    scope_masks: torch.Tensor | None,  # [n_scopes, semref_cap] bool
    semref_ktype: torch.Tensor | None,  # [semref_cap] i8
    boost_factor: float,
    *,
    semref_cap: int,
    n_seg: int,
    dedup_related: bool = False,
    window: int | None = None,
    e_max: int | None = None,
) -> _Runs:
    """The sorted core: see the module docstring. ``window`` caps each op's
    postings (the dense forms' window) and ``e_max`` the entries of the
    whole call (the COO form's ``e_pad``), as the JAX forms truncate."""
    if n_seg * (semref_cap + 1) > _RUN_KEYS:
        raise ValueError(
            f"{n_seg} segments x {semref_cap + 1} semref slots exceed the {_RUN_KEYS} "
            "(segment, semref) runs one call can key"
        )
    dev = offsets.device
    i64 = torch.int64
    t = tids.numel()
    n_terms = offsets.numel() - 1
    op_hit = torch.zeros(t, dtype=torch.bool, device=dev)
    empty = _Runs(
        torch.zeros(0, dtype=i64, device=dev), torch.zeros(4, 0, dtype=torch.float32, device=dev), op_hit
    )
    if t == 0 or n_terms <= 0:
        return empty
    tids = tids.to(i64)
    safe = tids.clamp(0, n_terms - 1)
    starts = offsets[safe]
    sizes = torch.where(tids >= 0, offsets[safe + 1] - starts, 0)
    if window is not None:
        sizes = sizes.clamp(max=window)
    ends = sizes.cumsum(0)
    full = int(ends[-1])  # one sync: the call's entry count
    if full == 0:
        return empty
    op = torch.repeat_interleave(torch.arange(t, device=dev), sizes, output_size=full)
    if e_max is not None and e_max < full:
        op = op[:e_max]
    entry = torch.arange(op.numel(), device=dev)
    pos_idx = starts[op] + (entry - (ends - sizes)[op])
    ids = post_semrefs[pos_idx].to(i64)
    seg = segs.to(i64)[op]
    kind = kinds[op]
    in_range = (seg >= 0) & (seg < n_seg)
    scoring = (kind <= OP_RELATED) & in_range
    if ktype_gate is not None:
        gate = ktype_gate.to(i64)[op]
        scoring &= (gate < 0) | (semref_ktype.to(i64)[ids] == gate)
    if scope_masks is not None:
        scoring &= scope_masks[scope_ids.to(i64)[op], ids]
    boost = (kind == OP_BOOST) & in_range
    op_hit[op[scoring]] = True

    live = (scoring | boost).nonzero().squeeze(1)
    if live.numel() == 0:
        return _Runs(empty.keys, empty.sums, op_hit)
    op, ids, seg, boost = op[live], ids[live], seg[live], boost[live]
    score = post_scores[pos_idx[live]] * weights[op]
    pos_field = torch.where(boost, _POS_P - 1, positions.to(i64)[op])
    key, perm = torch.sort(((seg * (semref_cap + 1) + ids) << _POS_BITS) | pos_field, stable=True)
    run = key >> _POS_BITS
    pos = key & (_POS_P - 1)
    kind, score, boost = kinds[op[perm]], score[perm], boost[perm]
    exact = ~boost & (kind == OP_EXACT)
    related = ~boost & (kind == OP_RELATED)

    n = key.numel()
    first = torch.ones(n, dtype=torch.bool, device=dev)
    first[1:] = run[1:] != run[:-1]
    run_starts = first.nonzero().squeeze(1)  # one sync: the run count
    run_id = first.cumsum(0) - 1
    run_bounds = torch.cat([run_starts, torch.tensor([n], device=dev)])
    # First adder: a related entry counts iff it holds its run's least
    # position; under dedup_related only its first (op, semref) entry does.
    winner = related & (pos == pos[run_starts][run_id])
    if dedup_related:
        dup_first = first.clone()
        dup_first[1:] |= pos[1:] != pos[:-1]
        winner &= dup_first
    # A run with a boost entry ends with one (boost sorts last).
    mult = torch.where(boost[run_bounds[1:] - 1][run_id], boost_factor, 1.0)
    score = score * mult
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    values = torch.stack(
        [
            torch.where(exact, score, zero),
            exact.float(),
            torch.where(winner, score, zero),
            winner.float(),
            (exact | related).float(),
        ],
        dim=1,
    )
    sums = torch.segment_reduce(values, "sum", offsets=run_bounds, axis=0)
    scored = sums[:, 4] > 0  # boost-only runs drop out
    return _Runs(run[run_starts][scored], sums[scored, :4].T.contiguous(), op_hit)


def accumulate_postings(
    offsets: torch.Tensor,  # [terms + 1] i64 CSR offsets
    post_semrefs: torch.Tensor,  # [postings] i32
    post_scores: torch.Tensor,  # [postings] f32
    tids: torch.Tensor,  # [t] query term ids (-1 = padding)
    weights: torch.Tensor,  # [t] f32 per-term weight
    exact: torch.Tensor,  # [t] bool exact vs related
    scope_mask: torch.Tensor,  # [semref_cap] bool (True = in scope)
    *,
    window: int,
    semref_cap: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over the query terms' postings (each cut at ``window``):
    exact and related score and hit tallies, related dropped where an exact
    term matched, folded with log smoothing.

    Returns (total_score[semref_cap], exact_hits, related_hits) — semrefs
    with zero hits have score 0.
    """
    dev = offsets.device
    t = tids.numel()
    zeros_t = torch.zeros(t, dtype=torch.int64, device=dev)
    # Every related term counts here (no first adder): all at position 0.
    runs = _accumulate_runs(
        offsets, post_semrefs, post_scores, tids, weights, zeros_t,
        torch.where(exact.to(dev), OP_EXACT, OP_RELATED), zeros_t, None, zeros_t,
        scope_mask.reshape(1, -1), None, 1.0,
        semref_cap=semref_cap, n_seg=1, window=window,
    )
    es, eh, rs, rh = runs.sums
    has_exact = eh > 0
    rs = torch.where(has_exact, 0.0, rs)
    rh = torch.where(has_exact, 0.0, rh)
    smooth = torch.where(rh > 1, torch.log(rh + 1.0) * rs / rh.clamp(min=1.0), rs)
    out = torch.zeros(3, semref_cap, dtype=torch.float32, device=dev)
    out[:, runs.keys] = torch.stack([es + smooth, eh, rh])
    return out[0], out[1], out[2]


def accumulate_postings_segmented(
    offsets: torch.Tensor,  # [terms + 1] i64 CSR offsets
    post_semrefs: torch.Tensor,  # [postings] i32
    post_scores: torch.Tensor,  # [postings] f32
    tids: torch.Tensor,  # [t] query term ids (-1 = padding)
    weights: torch.Tensor,  # [t] f32 per-op weight
    segs: torch.Tensor,  # [t] leaf segment per op
    kinds: torch.Tensor,  # [t] i8: 0 exact, 1 related, 2 boost-membership
    positions: torch.Tensor,  # [t] op position within its leaf (VM order)
    ktype_gate: torch.Tensor,  # [t] i8: -1 none, else required knowledge type
    scope_ids: torch.Tensor,  # [t] row into scope_masks per op
    scope_masks: torch.Tensor,  # [n_scopes, semref_cap] bool (True = in scope)
    semref_ktype: torch.Tensor,  # [semref_cap] i8
    boost_factor: float,  # entity-boost multiplier
    *,
    window: int,
    semref_cap: int,
    n_seg: int,
    dedup_related: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-leaf-segment accumulation replicating the host VM's
    per-sub-expression ``MatchAccumulator`` bookkeeping (the module
    docstring's rules), dense.

    Returns (exact_score, exact_hits, related_score, related_hits) each
    [n_seg, semref_cap], plus op_hit[t] (op had >= 1 in-scope posting).
    """
    runs = _accumulate_runs(
        offsets, post_semrefs, post_scores, tids, weights, segs, kinds, positions,
        ktype_gate, scope_ids, scope_masks, semref_ktype, float(boost_factor),
        semref_cap=semref_cap, n_seg=n_seg, dedup_related=dedup_related, window=window,
    )
    seg, col = runs.keys // (semref_cap + 1), runs.keys % (semref_cap + 1)
    out = torch.zeros(4, n_seg * semref_cap, dtype=torch.float32, device=offsets.device)
    out[:, seg * semref_cap + col] = runs.sums
    out = out.view(4, n_seg, semref_cap)
    return out[0], out[1], out[2], out[3], runs.op_hit


def _ranks(seg: torch.Tensor, n_seg: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(counts [n_seg], each run's rank within its segment) for runs in
    ascending (segment, semref) order."""
    counts = torch.bincount(seg, minlength=n_seg)
    rank = torch.arange(seg.numel(), device=seg.device) - (counts.cumsum(0) - counts)[seg]
    return counts, rank


def accumulate_postings_segmented_compact(
    *args: Any, cap: int, **kwargs: Any
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Segmented accumulation, compacted per segment.

    Returns (packed [4, n_seg, cap] f32: exact score, exact hits, related
    score, related hits of each segment's active semrefs in ascending
    ordinal order; op_hit [t]; order [n_seg, cap] i32: those semrefs;
    counts [n_seg] i32: each segment's active count). A count past ``cap``
    keeps only the segment's first ``cap`` semrefs: the caller takes the
    dense form then.
    """
    semref_cap, n_seg = kwargs["semref_cap"], kwargs["n_seg"]
    runs = _accumulate_runs(*args[:12], float(args[12]), **kwargs)
    dev = runs.keys.device
    seg, col = runs.keys // (semref_cap + 1), runs.keys % (semref_cap + 1)
    counts, rank = _ranks(seg, n_seg)
    keep = rank < cap
    seg, rank = seg[keep], rank[keep]
    packed = torch.zeros(4, n_seg, cap, dtype=torch.float32, device=dev)
    packed[:, seg, rank] = runs.sums[:, keep]
    order = torch.zeros(n_seg, cap, dtype=torch.int32, device=dev)
    order[seg, rank] = col[keep].to(torch.int32)
    return packed, runs.op_hit, order, counts.to(torch.int32)


def accumulate_postings_segmented_coo(
    offsets: torch.Tensor,
    post_semrefs: torch.Tensor,
    post_scores: torch.Tensor,
    tids: torch.Tensor,
    weights: torch.Tensor,
    segs: torch.Tensor,
    kinds: torch.Tensor,
    positions: torch.Tensor,
    ktype_gate: torch.Tensor,
    scope_ids: torch.Tensor,
    scope_masks: torch.Tensor,
    semref_ktype: torch.Tensor,
    boost_factor: float,
    *,
    e_pad: int,
    semref_cap: int,
    n_seg: int,
    dedup_related: bool = False,
    r_max: int = 4096,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The COO form: active runs only.

    Reads at most ``e_pad`` postings (the ops' lists flattened in op order)
    and returns (keys [r] i64 = seg * (semref_cap + 1) + semref, ascending,
    padding 2**30; sums [4, r] f32, zero past the runs; n_runs, a scalar,
    which may exceed r; op_hit [t]), r = min(r_max, e_pad), as the JAX
    form does. Positions must lie below ``_POS_P - 1``.
    """
    runs = _accumulate_runs(
        offsets, post_semrefs, post_scores, tids, weights, segs, kinds, positions,
        ktype_gate, scope_ids, scope_masks, semref_ktype, float(boost_factor),
        semref_cap=semref_cap, n_seg=n_seg, dedup_related=dedup_related, e_max=e_pad,
    )
    dev = offsets.device
    r = min(r_max, e_pad)
    n_runs = runs.keys.numel()
    keys = torch.full((r,), _DEAD_KEY, dtype=torch.int64, device=dev)
    sums = torch.zeros(4, r, dtype=torch.float32, device=dev)
    keys[: min(r, n_runs)] = runs.keys[:r]
    sums[:, : min(r, n_runs)] = runs.sums[:, :r]
    return keys, sums, torch.tensor(n_runs, dtype=torch.int32, device=dev), runs.op_hit


def accumulate_postings_segmented_coo_dp(
    ranks: list[tuple[tuple, dict]],
    seg_offsets: list[int],
) -> tuple[torch.Tensor, torch.Tensor, list[torch.Tensor]]:
    """The sorted core over data-parallel ranks: rank g's ``(operands,
    statics)`` (as :meth:`DevicePostingsIndex._prepare_operands` packs
    them, on the rank's device against its replica of the postings, with
    segments local to the rank) is launched before any rank's result is
    read. Rank g owns the global segments from ``seg_offsets[g]``; the
    offsets ascend, so its runs follow rank g-1's. Returns (keys [r] i64 =
    global segment * (semref_cap + 1) + semref, ascending; sums [4, r]
    f32; op_hit [t_g] per rank) on the first rank's device. The JAX form
    takes the ranks' op arrays stacked to one shape for ``shard_map``;
    here each rank keeps its own."""
    launched = [_accumulate_runs(*operands, **statics) for operands, statics in ranks]
    home = launched[0].keys.device
    width = ranks[0][1]["semref_cap"] + 1
    keys = torch.cat([r.keys.to(home) + lo * width for r, lo in zip(launched, seg_offsets)])
    sums = torch.cat([r.sums.to(home) for r in launched], dim=1)
    return keys, sums, [r.op_hit.to(home) for r in launched]


def _pack_runs(seg: np.ndarray, col: np.ndarray, sums: np.ndarray, n_seg: int):
    """Ascending (segment, semref column, sums [4, r]) runs as the COO
    route's ``(cols [n_seg, m], packed [4, n_seg, m], counts [n_seg])``."""
    counts = np.bincount(seg, minlength=n_seg).astype(np.int32)
    rank = np.arange(seg.size) - (np.cumsum(counts) - counts)[seg]
    m = max(int(counts.max(initial=0)), 1)
    cols = np.zeros((n_seg, m), dtype=np.int32)
    packed = np.zeros((4, n_seg, m), dtype=np.float32)
    cols[seg, rank] = col
    packed[:, seg, rank] = sums
    return cols, packed, counts


class DevicePostingsIndex:
    """Term -> scored semref postings with a device accumulator.

    The host side interns terms (the C++ interner when a compiler can build
    it) and collects postings; ``build()`` lays them out as CSR and copies
    them to ``device``. ``lookup_ops`` / ``lookup_ops_sparse`` run the
    segmented accumulation for a batch of ops, ``lookup_terms`` the
    single-scope one for (term, weight, exact) triples. Results come back
    as numpy arrays.
    """

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        self._interner = create_interner()
        self._built = False
        self._offsets: torch.Tensor | None = None
        self._semrefs: torch.Tensor | None = None
        self._scores: torch.Tensor | None = None
        self._semref_cap = 0
        self._n_semrefs = 0
        self._max_postings = 0
        self._offsets_host: np.ndarray | None = None
        self._semrefs_host: np.ndarray | None = None
        self._term_has_dups: np.ndarray = np.zeros(0, dtype=bool)
        # The semref-ktype vector and the all-True scope mask stay on the
        # device across calls.
        self._ktype_cache: tuple[np.ndarray, torch.Tensor] | None = None
        self._true_mask: torch.Tensor | None = None
        # CSR replicas on other devices (the dp ranks'), dropped on build.
        self._replicas: dict[torch.device, tuple[torch.Tensor, ...]] = {}
        self.dp_calls = 0  # lookup_ops_sparse_dp calls split over ranks

    def add_term(self, term: str, semref_id: int, score: float = 1.0) -> None:
        tid = self._interner.intern(term)
        self._interner.add_posting(tid, semref_id, score)
        self._n_semrefs = max(self._n_semrefs, semref_id + 1)
        self._built = False

    def add_terms_batch(
        self, terms: list[tuple[str, int]] | list[tuple[str, int, float]]
    ) -> None:
        """``add_term`` for each entry, in order, in two interner calls."""
        if not terms:
            return
        tids = self._interner.intern_batch([entry[0] for entry in terms])
        semrefs = np.array([entry[1] for entry in terms], dtype=np.int64)
        scores = np.array([entry[2] if len(entry) > 2 else 1.0 for entry in terms], dtype=np.float32)
        self._interner.add_postings_batch(tids, semrefs, scores)
        self._n_semrefs = max(self._n_semrefs, int(semrefs.max()) + 1)
        self._built = False

    def __len__(self) -> int:
        return len(self._interner)

    @property
    def posting_count(self) -> int:
        return self._interner.posting_count()

    def build(self) -> None:
        """(Re)build the CSR arrays and copy them to the device."""
        offsets, semrefs, scores = self._interner.build_csr()
        n_terms = len(offsets) - 1
        self._offsets = torch.from_numpy(offsets).to(self.device)
        self._semrefs = torch.from_numpy(semrefs).to(self.device)
        self._scores = torch.from_numpy(scores).to(self.device)
        self._semref_cap = round_up(max(self._n_semrefs, 1), 1024)
        sizes = np.diff(offsets)
        self._max_postings = int(sizes.max()) if len(sizes) else 0
        self._offsets_host = offsets
        self._semrefs_host = semrefs
        # Terms whose posting list repeats a semref (e.g. an entity whose
        # name equals one of its types): related lookups must dedup these.
        self._term_has_dups = np.zeros(n_terms, dtype=bool)
        if len(semrefs):
            term_of = np.repeat(np.arange(n_terms, dtype=np.int64), sizes)
            combo = np.sort(term_of * (self._semref_cap + 1) + semrefs)
            dup_pos = np.flatnonzero(combo[1:] == combo[:-1])
            self._term_has_dups[combo[dup_pos] // (self._semref_cap + 1)] = True
        self._ktype_cache = None  # semref_cap may have changed
        self._true_mask = None
        self._replicas = {}
        self._built = True

    def lookup(self, term: str) -> int:
        """Interned id for a term, or -1 if absent."""
        return self._interner.lookup(term)

    def posting_size(self, tid: int) -> int:
        """Posting-list length for an interned term id."""
        if not self._built:
            self.build()
        if tid < 0:
            return 0
        return int(self._offsets_host[tid + 1] - self._offsets_host[tid])

    def posting_semrefs(self, tid: int) -> np.ndarray:
        """Posting list (semref ordinals, in index insertion order) for an
        interned term id: the host VM's accumulator insertion order, which
        downstream stages observe."""
        if not self._built:
            self.build()
        if tid < 0:
            return np.empty(0, dtype=np.int32)
        return self._semrefs_host[self._offsets_host[tid] : self._offsets_host[tid + 1]]

    def lookup_ops(
        self,
        ops: list[tuple[int, float, int, int, int, int, int]],
        n_seg: int,
        semref_ktype: np.ndarray,
        scopes: list[np.ndarray | None] | None = None,
        boost_factor: float = 1.0,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Segmented accumulation, dense on the host (multi-query capable).

        ``ops``: (tid, weight, seg, kind, position, ktype_gate, scope_id)
        per lookup op (tid from :meth:`lookup`; kind per OP_* constants;
        ktype_gate -1 or a knowledge-type code; scope_id indexes ``scopes``).
        ``scopes``: one bool mask (or None = everything) per scope id —
        distinct queries batched into one call carry distinct scope rows.
        Returns host arrays (exact_score[n_seg, n], exact_hits,
        related_score, related_hits, op_hit[len(ops)]), n = n_semrefs.

        One pass of the sorted core; its run keys and sums come back and
        are scattered into the dense arrays here, on the host.
        """
        seg, col, sums, op_hit = self._host_runs(ops, n_seg, semref_ktype, scopes, boost_factor)
        dense = np.zeros((4, n_seg, self._n_semrefs), np.float32)
        dense[:, seg, col] = sums
        return dense[0], dense[1], dense[2], dense[3], op_hit

    def lookup_ops_sparse(
        self,
        ops: list[tuple[int, float, int, int, int, int, int]],
        n_seg: int,
        semref_ktype: np.ndarray,
        scopes: list[np.ndarray | None] | None = None,
        boost_factor: float = 1.0,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
        """Compact-form segmented accumulation (the COO route).

        Returns ``(cols [n_seg, m] i32 ascending-ordinal active columns,
        packed [4, n_seg, m] f32 (exact_score/exact_hits/related_score/
        related_hits), counts [n_seg] i32, op_hit [len(ops)] bool)``, or
        None when the caller must take :meth:`lookup_ops`: the call's
        (segment, semref) slots exceed the key's run field, or an op
        position does not fit its field.
        """
        if not self._built:
            self.build()
        if n_seg * (self._semref_cap + 1) >= _RUN_KEYS:
            return None
        if ops and max(op[4] for op in ops) > _POS_P - 2:
            return None
        seg, col, sums, op_hit = self._host_runs(ops, n_seg, semref_ktype, scopes, boost_factor)
        return (*_pack_runs(seg, col, sums, n_seg), op_hit)

    def _host_runs(self, ops, n_seg, semref_ktype, scopes, boost_factor):
        """One call of the sorted core, downloaded: (segment, semref column,
        sums [4, r], op_hit [len(ops)]) of its runs, in ascending order."""
        if not self._built:
            self.build()
        operands, statics = self._prepare_operands(ops, n_seg, semref_ktype, scopes, boost_factor)
        keys, sums, op_hit = (x.cpu().numpy() for x in _accumulate_runs(*operands, **statics))
        seg, col = np.divmod(keys, self._semref_cap + 1)
        return seg, col, sums, op_hit[: len(ops)]

    def lookup_ops_sparse_dp(
        self,
        ops: list[tuple[int, float, int, int, int, int, int]],
        n_seg: int,
        semref_ktype: np.ndarray,
        scopes: list[np.ndarray | None] | None = None,
        boost_factor: float = 1.0,
        *,
        mesh: Any = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray] | None:
        """:meth:`lookup_ops_sparse` over a mesh's data-parallel ranks: the
        segments split into one contiguous range per rank (balanced by
        posting totals), each rank's ops run through the sorted core on its
        first device against a replica of the postings, every rank
        launched before any is downloaded, and the runs come back in global
        segment numbering. Same return contract as
        :meth:`lookup_ops_sparse`; with one rank, or fewer than 2 segments,
        it is that call."""
        n_dp = mesh.shape[mesh.axis_names[0]] if mesh is not None else 1
        if n_dp <= 1 or n_seg < 2:
            return self.lookup_ops_sparse(ops, n_seg, semref_ktype, scopes, boost_factor)
        if not self._built:
            self.build()
        if ops and max(op[4] for op in ops) > _POS_P - 2:
            return None
        # Contiguous segment ranges balanced by posting totals.
        seg_cost = np.zeros(n_seg, dtype=np.int64)
        for op in ops:
            if op[0] >= 0:
                seg_cost[op[2]] += self.posting_size(op[0])
        cum = np.cumsum(seg_cost)
        bounds = sorted(
            {0, n_seg} | {int(np.searchsorted(cum, int(cum[-1]) * g / n_dp)) for g in range(1, n_dp)}
        )
        ranges = list(zip(bounds[:-1], bounds[1:]))
        if max(hi - lo for lo, hi in ranges) * (self._semref_cap + 1) >= _RUN_KEYS:
            return None
        self.dp_calls += 1
        groups = [[oi for oi, op in enumerate(ops) if lo <= op[2] < hi] for lo, hi in ranges]
        ranks = [
            self._prepare_operands(
                [(op[0], op[1], op[2] - lo, *op[3:]) for op in (ops[oi] for oi in idxs)],
                hi - lo, semref_ktype, scopes, boost_factor, device=mesh.devices[g, 0],
            )
            for g, ((lo, hi), idxs) in enumerate(zip(ranges, groups))
        ]
        keys, sums, hits = accumulate_postings_segmented_coo_dp(ranks, [lo for lo, _hi in ranges])
        seg, col = np.divmod(keys.cpu().numpy(), self._semref_cap + 1)
        op_hit = np.zeros(len(ops), dtype=bool)
        for idxs, hit in zip(groups, hits):
            op_hit[idxs] = hit[: len(idxs)].cpu().numpy()
        return (*_pack_runs(seg, col, sums.cpu().numpy(), n_seg), op_hit)

    def _csr_on(self, device: torch.device) -> tuple[torch.Tensor, ...]:
        """The CSR postings on ``device``: the index's own, or a replica
        copied there once per build."""
        if device == self._offsets.device:
            return self._offsets, self._semrefs, self._scores
        if device not in self._replicas:
            self._replicas[device] = tuple(
                t.to(device) for t in (self._offsets, self._semrefs, self._scores)
            )
        return self._replicas[device]

    def _prepare_operands(self, ops, n_seg, semref_ktype, scopes, boost_factor, device=None):
        """Shared operand packing for the segmented accumulation calls:
        (operands, statics), on the index's device or on ``device`` (a dp
        rank's, with its replica of the postings)."""
        arr = np.array([op[:1] + op[2:] for op in ops], dtype=np.int64).reshape(-1, 6)
        tids = arr[:, 0]
        known = tids[tids >= 0]
        related = arr[tids >= 0, 2] == OP_RELATED
        dedup_related = bool(self._term_has_dups[known[related]].any())
        cols = torch.from_numpy(np.ascontiguousarray(arr.T)).to(self.device)
        weights = torch.tensor([op[1] for op in ops], dtype=torch.float32).to(self.device)

        scopes = scopes or [None]
        if all(s is None for s in scopes):
            if self._true_mask is None:
                self._true_mask = torch.ones(1, self._semref_cap, dtype=torch.bool, device=self.device)
            masks = self._true_mask.expand(len(scopes), -1)
        else:
            host = np.zeros((len(scopes), self._semref_cap), dtype=bool)
            for row, scope in enumerate(scopes):
                if scope is None:
                    host[row, :] = True
                else:
                    host[row, : len(scope)] = scope
            masks = torch.from_numpy(host).to(self.device)
        # Value-keyed: a caller may edit its ktype array in place and pass
        # the same object; the cached host copy is ours.
        cached = self._ktype_cache
        if cached is None or cached[0].shape != semref_ktype.shape or not np.array_equal(cached[0], semref_ktype):
            padded = np.full(self._semref_cap, -1, dtype=np.int8)
            padded[: len(semref_ktype)] = semref_ktype
            self._ktype_cache = (np.array(semref_ktype, copy=True), torch.from_numpy(padded).to(self.device))
        operands = (
            cols[0], weights, cols[1], cols[2], cols[3], cols[4], cols[5],
            masks, self._ktype_cache[1],
        )
        if device is not None and device != self._offsets.device:
            operands = tuple(t.to(device) for t in operands)
        operands = (*self._csr_on(device or self._offsets.device), *operands, float(boost_factor))
        statics = dict(semref_cap=self._semref_cap, n_seg=n_seg, dedup_related=dedup_related)
        return operands, statics

    def lookup_terms(
        self,
        terms: list[tuple[str, float, bool]],
        scope_semrefs: np.ndarray | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Fused accumulation for (term_text, weight, is_exact) triples.

        scope_semrefs: optional bool mask over semref ordinals (True = in
        scope). Returns (total_score, exact_hits, related_hits) arrays over
        semref ordinals (length n_semrefs).
        """
        if not self._built:
            self.build()
        tids = np.array([self._interner.lookup(text) for text, _, _ in terms], dtype=np.int64)
        known = tids[tids >= 0]
        window = max(int((self._offsets_host[known + 1] - self._offsets_host[known]).max(initial=0)), 1)
        mask = np.zeros(self._semref_cap, dtype=bool)
        if scope_semrefs is None:
            mask[:] = True
        else:
            mask[: len(scope_semrefs)] = scope_semrefs
        total, exact_hits, related_hits = accumulate_postings(
            self._offsets,
            self._semrefs,
            self._scores,
            torch.from_numpy(tids).to(self.device),
            torch.tensor([w for _, w, _ in terms], dtype=torch.float32).to(self.device),
            torch.tensor([e for _, _, e in terms], dtype=torch.bool).to(self.device),
            torch.from_numpy(mask).to(self.device),
            window=window,
            semref_cap=self._semref_cap,
        )
        n = self._n_semrefs
        return total.cpu().numpy()[:n], exact_hits.cpu().numpy()[:n], related_hits.cpu().numpy()[:n]
