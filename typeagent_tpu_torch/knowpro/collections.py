"""Score accumulation + range scoping + term sets for query evaluation.

Behavioral parity with the reference's `knowpro/collections.py` (score/hit
bookkeeping is subtle and fixture-tested there):

  * ``Match`` keeps separate exact (score, hit_count) and related
    (related_score, related_hit_count) tallies; exact adds bump score+hits,
    related adds bump only the related pair (`collections.py:73-106`).
  * Total score folds related in via log-smoothing:
    ``smooth = log(hits+1) * (total/hits)`` (`collections.py:222-245`).
  * ``MessageAccumulator.add`` takes the max score and only bumps hits on
    improvement (`collections.py:404-414`).
  * Scope semantics: a range is in scope iff no selector's collection rejects
    it (`collections.py:542-562`).

The port of ``typeagent_tpu/knowpro/collections.py``, which is plain Python:
the same code over the port's data model.
"""

from __future__ import annotations

import bisect
import heapq
import math
import sys
from collections.abc import Callable, Iterable, Iterator
from dataclasses import dataclass, field

from .interfaces import (
    IMessage,
    IMessageCollection,
    ISemanticRefCollection,
    Knowledge,
    KnowledgeType,
    MessageOrdinal,
    ScoredMessageOrdinal,
    ScoredSemanticRefOrdinal,
    SemanticRef,
    SemanticRefOrdinal,
    Term,
    TextRange,
)

type KnowledgePredicate[T: Knowledge] = Callable[[T], bool]


# ---------------------------------------------------------------------------
# Scoring math
# ---------------------------------------------------------------------------


def get_smooth_score(total_score: float, hit_count: int) -> float:
    """Dampened multi-hit score: log(hits+1) * average. Related matches are
    noisy/duplicative, so N hits shouldn't score N times one hit."""
    match hit_count:
        case 0:
            return 0.0
        case 1:
            return total_score
        case _:
            return math.log(hit_count + 1) * (total_score / hit_count)


# ---------------------------------------------------------------------------
# Top-N primitives (used by the accumulators below)
# ---------------------------------------------------------------------------


@dataclass
class Scored[T]:
    item: T
    score: float

    # Heap/sort ordering is purely by score.
    def __lt__(self, other: "Scored[T]") -> bool:
        return self.score < other.score

    def __gt__(self, other: "Scored[T]") -> bool:
        return self.score > other.score

    def __le__(self, other: "Scored[T]") -> bool:
        return self.score <= other.score

    def __ge__(self, other: "Scored[T]") -> bool:
        return self.score >= other.score


class TopNCollection[T]:
    """Keeps the N best-scoring items (bounded min-heap)."""

    def __init__(self, max_count: int):
        self._max_count = max_count
        self._heap: list[Scored[T]] = []

    def __len__(self) -> int:
        return len(self._heap)

    def reset(self) -> None:
        self._heap = []

    def pop(self) -> Scored[T]:
        return heapq.heappop(self._heap)

    def top(self) -> Scored[T]:
        return self._heap[0]

    def push(self, item: T, score: float) -> None:
        entry = Scored(item, score)
        if len(self._heap) < self._max_count:
            heapq.heappush(self._heap, entry)
        else:
            heapq.heappushpop(self._heap, entry)

    def by_rank(self) -> list[Scored[T]]:
        return sorted(self._heap, reverse=True)

    def values_by_rank(self) -> list[T]:
        return [s.item for s in self.by_rank()]


class TopNList[T](TopNCollection[T]):
    """Alias for TopNCollection."""


class TopNListAll[T](TopNList[T]):
    """Top-N with no limit (N = sys.maxsize)."""

    def __init__(self):
        super().__init__(sys.maxsize)


def get_top_k[T](scored_items: Iterable[Scored[T]], top_k: int) -> list[Scored[T]]:
    top = TopNCollection[T](top_k)
    for scored in scored_items:
        top.push(scored.item, scored.score)
    return top.by_rank()


# ---------------------------------------------------------------------------
# Match accumulation
# ---------------------------------------------------------------------------


@dataclass
class Match[T]:
    value: T
    score: float
    hit_count: int
    related_score: float
    related_hit_count: int


def add_smooth_related_score_to_match_score[T](match: Match[T]) -> None:
    if match.related_hit_count > 0:
        match.score += get_smooth_score(match.related_score, match.related_hit_count)


def smooth_match_score[T](match: Match[T]) -> None:
    if match.hit_count > 0:
        match.score = get_smooth_score(match.score, match.hit_count)


class MatchAccumulator[T]:
    """Accumulates per-value match scores with exact/related bookkeeping.

    Exact occurrences bump (score, hit_count); related occurrences bump only
    (related_score, related_hit_count), so hit-count filters can weed out
    values that matched nothing exactly.
    """

    def __init__(self):
        self._matches: dict[T, Match[T]] = {}

    # dict-like surface ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._matches)

    def __iter__(self) -> Iterator[Match[T]]:
        return iter(self._matches.values())

    def __contains__(self, value: T) -> bool:
        return value in self._matches

    def get_match(self, value: T) -> Match[T] | None:
        return self._matches.get(value)

    def set_match(self, match: Match[T]) -> None:
        self._matches[match.value] = match

    def set_matches(self, matches: Iterable[Match[T]], *, clear: bool = False) -> None:
        if clear:
            self.clear_matches()
        for match in matches:
            self.set_match(match)

    def get_matched_values(self) -> Iterator[T]:
        return iter(self._matches)

    def get_matches(
        self, predicate: Callable[[Match[T]], bool] | None = None
    ) -> Iterator[Match[T]]:
        values = self._matches.values()
        return filter(predicate, values) if predicate else iter(values)

    def clear_matches(self) -> None:
        self._matches.clear()

    # accumulation -----------------------------------------------------------

    def add(self, value: T, score: float, is_exact_match: bool = True) -> None:
        existing = self._matches.get(value)
        if existing is None:
            self._matches[value] = (
                Match(value, score, 1, 0.0, 0)
                if is_exact_match
                else Match(value, 0.0, 0, score, 1)
            )
        elif is_exact_match:
            existing.score += score
            existing.hit_count += 1
        else:
            existing.related_score += score
            existing.related_hit_count += 1

    def combine_matches(self, match: Match[T], other: Match[T]) -> None:
        match.score += other.score
        match.hit_count += other.hit_count
        match.related_score += other.related_score
        match.related_hit_count += other.related_hit_count

    def add_union(self, other: "MatchAccumulator[T]") -> None:
        for incoming in other:
            mine = self._matches.get(incoming.value)
            if mine is None:
                self.set_match(incoming)
            else:
                self.combine_matches(mine, incoming)

    def intersect(
        self, other: "MatchAccumulator[T]", intersection: "MatchAccumulator[T]"
    ) -> "MatchAccumulator[T]":
        for mine in self:
            theirs = other.get_match(mine.value)
            if theirs is not None:
                self.combine_matches(mine, theirs)
                intersection.set_match(mine)
        return intersection

    def calculate_total_score(
        self, scorer: Callable[[Match[T]], None] | None = None
    ) -> None:
        apply = scorer or add_smooth_related_score_to_match_score
        for match in self:
            apply(match)

    # selection --------------------------------------------------------------

    def get_max_hit_count(self) -> int:
        return max((m.hit_count for m in self._matches.values()), default=0)

    def matches_with_min_hit_count(
        self, min_hit_count: int | None
    ) -> Iterable[Match[T]]:
        if not min_hit_count or min_hit_count <= 0:
            return self._matches.values()
        return (m for m in self._matches.values() if m.hit_count >= min_hit_count)

    # internal alias kept for subclass use
    _min_hit_matches = matches_with_min_hit_count

    def get_sorted_by_score(self, min_hit_count: int | None = None) -> list[Match[T]]:
        return sorted(
            self.matches_with_min_hit_count(min_hit_count),
            key=lambda m: m.score,
            reverse=True,
        )

    def get_top_n_scoring(
        self,
        max_matches: int | None = None,
        min_hit_count: int | None = None,
    ) -> list[Match[T]]:
        if not self._matches:
            return []
        if not max_matches or max_matches <= 0:
            return self.get_sorted_by_score(min_hit_count)
        top = TopNCollection[T](max_matches)
        for match in self.matches_with_min_hit_count(min_hit_count):
            top.push(match.value, match.score)
        return [self._matches[s.item] for s in top.by_rank()]

    def get_with_hit_count(self, min_hit_count: int) -> list[Match[T]]:
        return list(self.matches_with_min_hit_count(min_hit_count))

    def select_top_n_scoring(
        self,
        max_matches: int | None = None,
        min_hit_count: int | None = None,
    ) -> int:
        keep = self.get_top_n_scoring(max_matches, min_hit_count)
        self.set_matches(keep, clear=True)
        return len(keep)

    def select_with_hit_count(self, min_hit_count: int) -> int:
        keep = self.get_with_hit_count(min_hit_count)
        self.set_matches(keep, clear=True)
        return len(keep)


class SemanticRefAccumulator(MatchAccumulator[SemanticRefOrdinal]):
    """MatchAccumulator over semref ordinals + the set of matched term texts."""

    def __init__(self, search_term_matches: set[str] | None = None):
        super().__init__()
        self.search_term_matches: set[str] = (
            set() if search_term_matches is None else search_term_matches
        )

    @staticmethod
    def _effective_weight(search_term: Term, weight: float | None) -> float:
        if weight is not None:
            return weight
        return 1.0 if search_term.weight is None else search_term.weight

    def add_term_matches(
        self,
        search_term: Term,
        scored_refs: Iterable[ScoredSemanticRefOrdinal] | None,
        is_exact_match: bool,
        *,
        weight: float | None = None,
    ) -> None:
        if scored_refs is None:
            return
        w = self._effective_weight(search_term, weight)
        for scored_ref in scored_refs:
            self.add(scored_ref.semantic_ref_ordinal, scored_ref.score * w,
                     is_exact_match)
        self.search_term_matches.add(search_term.text)

    def add_term_matches_if_new(
        self,
        search_term: Term,
        scored_refs: Iterable[ScoredSemanticRefOrdinal] | None,
        is_exact_match: bool,
        weight: float | None = None,
    ) -> None:
        """Like add_term_matches but never re-scores an already-matched ref
        (used so related terms can't double-count an exact match)."""
        if scored_refs is None:
            return
        w = self._effective_weight(search_term, weight)
        for scored_ref in scored_refs:
            ordinal = scored_ref.semantic_ref_ordinal
            if ordinal not in self:
                self.add(ordinal, scored_ref.score * w, is_exact_match)
        self.search_term_matches.add(search_term.text)

    async def get_semantic_refs(
        self,
        semantic_refs: ISemanticRefCollection,
        predicate: Callable[[SemanticRef], bool],
    ) -> list[SemanticRef]:
        out: list[SemanticRef] = []
        for match in self:
            ref = await semantic_refs.get_item(match.value)
            if predicate is None or predicate(ref):
                out.append(ref)
        return out

    def get_matches_of_type[TK: Knowledge](
        self,
        semantic_refs: list[SemanticRef],
        knowledge_type: KnowledgeType,
        predicate: KnowledgePredicate[TK] | None = None,
    ) -> Iterable[Match[SemanticRefOrdinal]]:
        for match in self:
            knowledge = semantic_refs[match.value].knowledge
            if predicate is None or predicate(knowledge):  # type: ignore[arg-type]
                yield match

    async def group_matches_by_type(
        self, semantic_refs: ISemanticRefCollection
    ) -> dict[KnowledgeType, "SemanticRefAccumulator"]:
        # One metadata round-trip for the whole accumulator (the reference
        # dereferences refs one by one).
        matches = list(self)
        if not matches:
            return {}
        metadata = await semantic_refs.get_metadata_multiple(
            [m.value for m in matches]
        )
        groups: dict[KnowledgeType, SemanticRefAccumulator] = {}
        for match, meta in zip(matches, metadata):
            groups.setdefault(
                meta.knowledge_type, SemanticRefAccumulator(self.search_term_matches)
            ).set_match(match)
        return groups

    async def get_matches_in_scope(
        self,
        semantic_refs: ISemanticRefCollection,
        ranges_in_scope: "TextRangesInScope",
    ) -> "SemanticRefAccumulator":
        scoped = SemanticRefAccumulator(self.search_term_matches)
        matches = list(self)
        if matches:
            metadata = await semantic_refs.get_metadata_multiple(
                [m.value for m in matches]
            )
            scoped.set_matches(
                m
                for m, meta in zip(matches, metadata)
                if ranges_in_scope.is_range_in_scope(meta.range)
            )
        return scoped

    def add_union(self, other: MatchAccumulator[SemanticRefOrdinal]) -> None:
        assert isinstance(other, SemanticRefAccumulator)
        super().add_union(other)
        self.search_term_matches |= other.search_term_matches

    def intersect(
        self,
        other: MatchAccumulator[SemanticRefOrdinal],
        intersection: MatchAccumulator[SemanticRefOrdinal] | None = None,
    ) -> "SemanticRefAccumulator":
        assert isinstance(other, SemanticRefAccumulator)
        result = intersection if intersection is not None else SemanticRefAccumulator()
        assert isinstance(result, SemanticRefAccumulator)
        super().intersect(other, result)
        if len(result):
            result.search_term_matches |= self.search_term_matches
            result.search_term_matches |= other.search_term_matches
        return result

    def to_scored_semantic_refs(self) -> list[ScoredSemanticRefOrdinal]:
        return [
            ScoredSemanticRefOrdinal.fast(m.value, m.score)
            for m in self.get_sorted_by_score()
        ]


class MessageAccumulator(MatchAccumulator[MessageOrdinal]):
    """Max-merge accumulator: a message's score is its best chunk/semref score."""

    def __init__(self, matches: list[Match[MessageOrdinal]] | None = None):
        super().__init__()
        if matches:
            self.set_matches(matches)

    def add(
        self, value: MessageOrdinal, score: float, is_exact_match: bool = True
    ) -> None:
        match = self.get_match(value)
        if match is None:
            self.set_match(Match(value, score, 1, 0.0, 0))
        elif score > match.score:
            # Better evidence: take the new score and count the improvement.
            match.score = score
            match.hit_count += 1

    def add_messages_for_semantic_ref(
        self, semantic_ref: SemanticRef, score: float
    ) -> None:
        span = semantic_ref.range
        last = (
            span.end.message_ordinal if span.end is not None
            else span.start.message_ordinal
        )
        for ordinal in range(span.start.message_ordinal, last + 1):
            self.add(ordinal, score)

    def add_scored_matches(self, scored_ordinals: list[ScoredMessageOrdinal]) -> None:
        for scored in scored_ordinals:
            self.add(scored.message_ordinal, scored.score)

    @staticmethod
    def from_scored_ordinals(
        ordinals: list[ScoredMessageOrdinal] | None,
    ) -> "MessageAccumulator":
        accumulator = MessageAccumulator()
        if ordinals:
            accumulator.add_scored_matches(ordinals)
        return accumulator

    def intersect(
        self,
        other: MatchAccumulator[MessageOrdinal],
        intersection: MatchAccumulator[MessageOrdinal] | None = None,
    ) -> "MessageAccumulator":
        result = intersection if intersection is not None else MessageAccumulator()
        assert isinstance(result, MessageAccumulator)
        super().intersect(other, result)
        return result

    def smooth_scores(self) -> None:
        for match in self:
            smooth_match_score(match)

    def to_scored_message_ordinals(self) -> list[ScoredMessageOrdinal]:
        return [
            ScoredMessageOrdinal(m.value, m.score) for m in self.get_sorted_by_score()
        ]

    async def select_messages_in_budget(
        self, messages: IMessageCollection, max_chars_in_budget: int
    ) -> None:
        ranked = self.get_sorted_by_score()
        count = await get_count_of_messages_in_char_budget(
            messages, (m.value for m in ranked), max_chars_in_budget
        )
        self.set_matches(ranked[:count], clear=True)


# ---------------------------------------------------------------------------
# Message character budgeting
# ---------------------------------------------------------------------------


def get_message_char_count(message: IMessage) -> int:
    return sum(map(len, message.text_chunks))


async def get_count_of_messages_in_char_budget(
    messages: IMessageCollection,
    message_ordinals: Iterable[MessageOrdinal],
    max_chars_in_budget: int,
) -> int:
    """How many best-first messages fit in the character budget."""
    taken, used = 0, 0
    for ordinal in message_ordinals:
        used += get_message_char_count(await messages.get_item(ordinal))
        if used > max_chars_in_budget:
            break
        taken += 1
    return taken


def add_to_set[T](target: set[T], values: Iterable[T]) -> None:
    target.update(values)


# ---------------------------------------------------------------------------
# Range scoping
# ---------------------------------------------------------------------------


@dataclass
class TextRangeCollection(Iterable[TextRange]):
    """Sorted, deduped ranges with bisect insert + containment probe."""

    _ranges: list[TextRange]

    def __init__(
        self,
        ranges: list[TextRange] | None = None,
        ensure_sorted: bool = False,
    ) -> None:
        if not ensure_sorted:
            self._ranges = ranges if ranges is not None else []
        else:
            self._ranges = []
            if ranges:
                self.add_ranges(ranges)

    def __len__(self) -> int:
        return len(self._ranges)

    def __iter__(self) -> Iterator[TextRange]:
        return iter(self._ranges)

    def get_ranges(self) -> list[TextRange]:
        return self._ranges

    def add_range(self, text_range: TextRange) -> bool:
        pos = bisect.bisect_left(self._ranges, text_range)
        if pos != len(self._ranges) and self._ranges[pos] == text_range:
            return False  # duplicate
        self._ranges.insert(pos, text_range)
        return True

    def add_ranges(self, text_ranges: "list[TextRange] | TextRangeCollection") -> None:
        items = text_ranges if isinstance(text_ranges, list) else text_ranges._ranges
        for text_range in items:
            self.add_range(text_range)

    def contains_range(self, inner_range: TextRange) -> bool:
        # Candidate containers all have start <= inner.start; walk backwards
        # from the last such range.
        hi = bisect.bisect_right(
            self._ranges, inner_range.start, key=lambda r: r.start
        )
        return any(inner_range in self._ranges[i] for i in reversed(range(hi)))


@dataclass
class TextRangesInScope:
    """Intersection-of-selectors scope: in scope iff no selector rejects."""

    text_ranges: list[TextRangeCollection] | None = None

    def add_text_ranges(self, ranges: TextRangeCollection) -> None:
        if self.text_ranges is None:
            self.text_ranges = []
        self.text_ranges.append(ranges)

    def is_range_in_scope(self, inner_range: TextRange) -> bool:
        return all(
            selector.contains_range(inner_range)
            for selector in (self.text_ranges or ())
        )


# ---------------------------------------------------------------------------
# Term sets
# ---------------------------------------------------------------------------


@dataclass
class TermSet:
    """Terms keyed by text; union keeps the max weight per term.

    NOTE: add_or_union bumps the FIRST-seen Term object's weight in place —
    downstream dedupe relies on that aliasing (see reference collections.py
    add_or_union and tests/test_reltermsindex.py).
    """

    terms: dict[str, Term]

    def __init__(self, terms: list[Term] | None = None):
        self.terms = {}
        self.add_or_union(terms)

    def __len__(self) -> int:
        return len(self.terms)

    def __contains__(self, term: Term) -> bool:
        return term.text in self.terms

    def add(self, term: Term) -> bool:
        if term.text in self.terms:
            return False
        self.terms[term.text] = term
        return True

    def add_or_union(self, terms: Term | list[Term] | None) -> None:
        match terms:
            case None:
                pass
            case list():
                for term in terms:
                    self.add_or_union(term)
            case _:
                held = self.terms.get(terms.text)
                if held is None:
                    self.terms[terms.text] = terms
                elif (terms.weight or 0) > (held.weight or 0):
                    held.weight = terms.weight or 0

    def get(self, term: str | Term) -> Term | None:
        return self.terms.get(term if isinstance(term, str) else term.text)

    def get_weight(self, term: Term) -> float | None:
        held = self.terms.get(term.text)
        return None if held is None else held.weight

    def remove(self, term: Term) -> None:
        self.terms.pop(term.text, None)

    def clear(self) -> None:
        self.terms.clear()

    def values(self) -> list[Term]:
        return list(self.terms.values())


@dataclass
class PropertyTermSet:
    """Dedupe set of (property name, value term) pairs."""

    terms: dict[str, Term] = field(default_factory=dict)

    @staticmethod
    def _make_key(property_name: str, property_value: Term | str) -> str:
        text = (
            property_value.text
            if isinstance(property_value, Term)
            else property_value
        )
        return f"{property_name}:{text}"

    def add(self, property_name: str, property_value: Term) -> None:
        self.terms.setdefault(self._make_key(property_name, property_value),
                              property_value)

    def has(self, property_name: str, property_value: Term | str) -> bool:
        return self._make_key(property_name, property_value) in self.terms

    def clear(self) -> None:
        self.terms.clear()
