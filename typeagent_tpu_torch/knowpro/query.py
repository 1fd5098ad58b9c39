"""Query expression VM: compiled boolean trees over the six indexes.

The port of ``typeagent_tpu/knowpro/query.py`` (plain Python and numpy, the
same code); the stage-3 host VM that ``query()`` runs.

(Parity: reference knowpro/query.py. The expression tree is evaluated against
a QueryEvalContext; semantics preserved exactly:

  * OR unions accumulators; OR-MAX keeps only matches at the max hit count
    when > 1; AND intersects and requires a hit per term expression.
  * Term matches dedupe via context.matched_terms; related-term matches only
    count for semrefs not already matched by the search term itself.
  * Scope = TextRangesInScope built from selectors (date range, messages,
    threads, precomputed ranges); scoped lookups filter postings by range
    containment using lightweight semref metadata.
  * Tag/topic '*' wildcards scan by knowledge type.
  * Message-side booleans accumulate messages from semref ranges; re-ranking
    uses the message embedding index's subset lookup (a gather+matmul on the
    store's device rather than the reference's numpy fancy-indexing).)
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable
from dataclasses import dataclass, field
from typing import Literal, Protocol, cast

import numpy as np

from .collections import (
    Match,
    MatchAccumulator,
    MessageAccumulator,
    PropertyTermSet,
    SemanticRefAccumulator,
    TermSet,
    TextRangeCollection,
    TextRangesInScope,
)
from .common import is_search_term_wildcard
from .interfaces import (
    DateRange,
    Datetime,
    IConversation,
    IMessage,
    IMessageCollection,
    IPropertyToSemanticRefIndex,
    ISemanticRefCollection,
    ITermToSemanticRefIndex,
    ITimestampToTextRangeIndex,
    KnowledgeType,
    MessageOrdinal,
    PropertySearchTerm,
    ScoredMessageOrdinal,
    ScoredSemanticRefOrdinal,
    SearchTerm,
    SemanticRef,
    SemanticRefMetadata,
    SemanticRefOrdinal,
    SemanticRefSearchResult,
    Term,
    TextLocation,
    TextRange,
    Thread,
)
from .kplib import ConcreteEntity
from .propindex import PropertyNames, lookup_property_in_property_index
from .utils import aenumerate

type BooleanOp = Literal["and", "or", "or_max"]

type ScoreBoosterType = Callable[
    [SearchTerm, SemanticRef, ScoredSemanticRefOrdinal], ScoredSemanticRefOrdinal
]


# ---------------------------------------------------------------------------
# Compiled-term plumbing (shared with search.py / reltermsindex.py)
# ---------------------------------------------------------------------------


@dataclass
class CompiledSearchTerm(SearchTerm):
    related_terms_required: bool = False


@dataclass
class CompiledTermGroup:
    boolean_op: BooleanOp
    terms: list[CompiledSearchTerm]


def to_required_search_term(term: SearchTerm) -> CompiledSearchTerm:
    # Must alias the input object: later related_terms assignments must stick.
    cst = cast(CompiledSearchTerm, term)
    cst.related_terms_required = True
    return cst


def to_non_required_search_term(term: SearchTerm) -> CompiledSearchTerm:
    cst = cast(CompiledSearchTerm, term)
    cst.related_terms_required = False
    return cst


# ---------------------------------------------------------------------------
# Text/term matching helpers
# ---------------------------------------------------------------------------


def is_conversation_searchable(conversation: IConversation) -> bool:
    return None not in (
        conversation.semantic_ref_index,
        conversation.semantic_refs,
    )


def get_matching_term_for_text(search_term: SearchTerm, text: str) -> Term | None:
    # Case-insensitive: stored entities may differ in case.
    lowered = text.lower()
    if lowered == search_term.term.text.lower():
        return search_term.term
    for related in search_term.related_terms or ():
        if lowered == related.text.lower():
            return related
    return None


def match_search_term_to_text(search_term: SearchTerm, text: str | None) -> bool:
    return bool(text) and get_matching_term_for_text(search_term, text) is not None


def match_search_term_to_one_of_text(
    search_term: SearchTerm, texts: list[str] | None
) -> bool:
    return any(match_search_term_to_text(search_term, t) for t in texts or ())


def match_entity_name_or_type(
    property_value: SearchTerm, entity: ConcreteEntity
) -> bool:
    return match_search_term_to_text(
        property_value, entity.name
    ) or match_search_term_to_one_of_text(property_value, entity.type)


def text_range_from_message(message_ordinal: MessageOrdinal) -> TextRange:
    return TextRange(start=TextLocation(message_ordinal))


def text_ranges_from_message_ordinals(
    message_ordinals: list[MessageOrdinal],
) -> list[TextRange]:
    return [text_range_from_message(o) for o in message_ordinals]


# ---------------------------------------------------------------------------
# Index lookups (scope-aware)
# ---------------------------------------------------------------------------


async def lookup_term_filtered(
    semantic_ref_index: ITermToSemanticRefIndex,
    term: Term,
    semantic_refs: ISemanticRefCollection,
    filter: Callable[[SemanticRefMetadata, ScoredSemanticRefOrdinal], bool],
) -> list[ScoredSemanticRefOrdinal] | None:
    scored_refs = await semantic_ref_index.lookup_term(term.text)
    if not scored_refs:
        return None
    metadata = await semantic_refs.get_metadata_multiple(
        [sr.semantic_ref_ordinal for sr in scored_refs]
    )
    return [sr for sr, m in zip(scored_refs, metadata) if filter(m, sr)]


async def lookup_term(
    semantic_ref_index: ITermToSemanticRefIndex,
    term: Term,
    semantic_refs: ISemanticRefCollection,
    ranges_in_scope: TextRangesInScope | None = None,
    knowledge_type: KnowledgeType | None = None,
) -> list[ScoredSemanticRefOrdinal] | None:
    if ranges_in_scope is None:
        return await semantic_ref_index.lookup_term(term.text)

    def in_scope(m: SemanticRefMetadata, _sr: ScoredSemanticRefOrdinal) -> bool:
        if knowledge_type and m.knowledge_type != knowledge_type:
            return False
        return ranges_in_scope.is_range_in_scope(m.range)

    return await lookup_term_filtered(
        semantic_ref_index, term, semantic_refs, in_scope
    )


async def lookup_knowledge_type(
    semantic_refs: ISemanticRefCollection, knowledge_type: KnowledgeType
) -> list[ScoredSemanticRefOrdinal]:
    return [
        ScoredSemanticRefOrdinal.fast(sr.semantic_ref_ordinal, 1.0)
        async for sr in semantic_refs
        if sr.knowledge.knowledge_type == knowledge_type
    ]


async def get_text_range_for_date_range(
    conversation: IConversation, date_range: DateRange
) -> TextRange | None:
    """Scan messages for the contiguous ordinal range inside the date range."""
    first = last = -1
    async for ordinal, message in aenumerate(conversation.messages):
        ts = message.timestamp
        if ts and Datetime.fromisoformat(ts) in date_range:
            if first < 0:
                first = ordinal
            last = ordinal
        elif first >= 0:
            break  # messages are time-ordered; the range has ended
    if first < 0:
        return None
    return TextRange(start=TextLocation(first), end=TextLocation(last + 1))


# ---------------------------------------------------------------------------
# Evaluation context + expression base
# ---------------------------------------------------------------------------


@dataclass
class QueryEvalContext[TMessage: IMessage, TIndex: ITermToSemanticRefIndex]:
    """Evaluation context: conversation + secondary indexes + matched-term sets."""

    conversation: IConversation[TMessage, TIndex]
    property_index: IPropertyToSemanticRefIndex | None = None
    timestamp_index: ITimestampToTextRangeIndex | None = None
    matched_terms: TermSet = field(init=False, default_factory=TermSet)
    matched_property_terms: PropertyTermSet = field(
        init=False, default_factory=PropertyTermSet
    )
    text_ranges_in_scope: TextRangesInScope | None = field(
        init=False, default_factory=TextRangesInScope
    )

    def __post_init__(self) -> None:
        if not is_conversation_searchable(self.conversation):
            raise ValueError(
                f"{self.conversation.name_tag} is not initialized and cannot be searched."
            )

    @property
    def semantic_ref_index(self) -> ITermToSemanticRefIndex:
        index = self.conversation.semantic_ref_index
        assert index is not None
        return index

    @property
    def semantic_refs(self) -> ISemanticRefCollection:
        refs = self.conversation.semantic_refs
        assert refs is not None
        return refs

    @property
    def messages(self) -> IMessageCollection:
        return self.conversation.messages

    async def get_semantic_ref(self, ordinal: SemanticRefOrdinal) -> SemanticRef:
        return await self.semantic_refs.get_item(ordinal)

    async def get_message_for_ref(self, semantic_ref: SemanticRef) -> TMessage:
        return await self.messages.get_item(semantic_ref.range.start.message_ordinal)

    async def get_message(self, message_ordinal: MessageOrdinal) -> TMessage:
        return await self.messages.get_item(message_ordinal)

    def clear_matched_terms(self) -> None:
        self.matched_terms.clear()
        self.matched_property_terms.clear()


class IQueryOpExpr[T](Protocol):
    async def eval(self, context: QueryEvalContext) -> T: ...


class QueryOpExpr[T](IQueryOpExpr[T]):
    """Base class for query operation expressions."""


class NoOpExpr[T](QueryOpExpr[T]):
    def __init__(self, src_expr: IQueryOpExpr[T]) -> None:
        self.src_expr = src_expr

    async def eval(self, context: QueryEvalContext) -> T:
        return await self.src_expr.eval(context)


# ---------------------------------------------------------------------------
# Scope selectors
# ---------------------------------------------------------------------------


class IQueryTextRangeSelector(Protocol):
    async def eval(
        self,
        context: QueryEvalContext,
        semantic_refs: SemanticRefAccumulator | None = None,
    ) -> TextRangeCollection | None: ...


@dataclass
class GetScopeExpr(QueryOpExpr[TextRangesInScope]):
    range_selectors: list[IQueryTextRangeSelector]

    async def eval(self, context: QueryEvalContext) -> TextRangesInScope:
        scope = TextRangesInScope()
        for selector in self.range_selectors:
            collection = await selector.eval(context)
            if collection is not None:
                scope.add_text_ranges(collection)
        return scope


class TextRangeSelector(IQueryTextRangeSelector):
    """Pre-computed ranges supplied by the caller."""

    def __init__(self, ranges_in_scope: list[TextRange]) -> None:
        self.text_ranges_in_scope = TextRangeCollection(ranges_in_scope, True)

    async def eval(
        self,
        context: QueryEvalContext,
        semantic_refs: SemanticRefAccumulator | None = None,
    ) -> TextRangeCollection | None:
        return self.text_ranges_in_scope


@dataclass
class TextRangesInDateRangeSelector(IQueryTextRangeSelector):
    date_range_in_scope: DateRange

    async def eval(
        self,
        context: QueryEvalContext,
        semantic_refs: SemanticRefAccumulator | None = None,
    ) -> TextRangeCollection | None:
        ranges = TextRangeCollection()
        index = context.timestamp_index
        if index is not None:
            for timed in await index.lookup_range(self.date_range_in_scope):
                ranges.add_range(timed.range)
            return ranges
        # No timestamp index: derive the ordinal range by scanning messages.
        found = await get_text_range_for_date_range(
            context.conversation, self.date_range_in_scope
        )
        if found is not None:
            ranges.add_range(found)
        return ranges


@dataclass
class TextRangesFromMessagesSelector(IQueryTextRangeSelector):
    source_expr: IQueryOpExpr[MessageAccumulator]

    async def eval(
        self,
        context: QueryEvalContext,
        semantic_refs: SemanticRefAccumulator | None = None,
    ) -> TextRangeCollection | None:
        matches = await self.source_expr.eval(context)
        if not matches:
            return TextRangeCollection(None)
        ordinals = sorted(matches.get_matched_values())
        return TextRangeCollection(text_ranges_from_message_ordinals(ordinals))


@dataclass
class ThreadSelector(IQueryTextRangeSelector):
    threads: list[Thread]

    async def eval(
        self,
        context: QueryEvalContext,
        semantic_refs: SemanticRefAccumulator | None = None,
    ) -> TextRangeCollection | None:
        collected = TextRangeCollection()
        for thread in self.threads:
            collected.add_ranges(list(thread.ranges))
        return collected


# ---------------------------------------------------------------------------
# Term-matching expressions
# ---------------------------------------------------------------------------


class MatchTermExpr(QueryOpExpr[SemanticRefAccumulator | None], ABC):
    async def eval(self, context: QueryEvalContext) -> SemanticRefAccumulator | None:
        matches = SemanticRefAccumulator()
        await self.accumulate_matches(context, matches)
        return matches if len(matches) else None

    @abstractmethod
    async def accumulate_matches(
        self, context: QueryEvalContext, matches: SemanticRefAccumulator
    ) -> None: ...


@dataclass
class MatchSearchTermExpr(MatchTermExpr):
    search_term: SearchTerm
    score_booster: ScoreBoosterType | None = None

    async def accumulate_matches(
        self, context: QueryEvalContext, matches: SemanticRefAccumulator
    ) -> None:
        main = self.search_term.term
        await self.accumulate_matches_for_term(context, matches, main)
        for related in self.search_term.related_terms or ():
            await self.accumulate_matches_for_term(context, matches, main, related)

    async def lookup_term(
        self, context: QueryEvalContext, term: Term
    ) -> list[ScoredSemanticRefOrdinal] | None:
        found = await lookup_term(
            context.semantic_ref_index,
            term,
            context.semantic_refs,
            context.text_ranges_in_scope,
        )
        if not found or self.score_booster is None:
            return found
        return [
            self.score_booster(
                self.search_term,
                await context.get_semantic_ref(sr.semantic_ref_ordinal),
                sr,
            )
            for sr in found
        ]

    async def accumulate_matches_for_term(
        self,
        context: QueryEvalContext,
        matches: SemanticRefAccumulator,
        term: Term,
        related_term: Term | None = None,
    ) -> None:
        if related_term is None:
            if term in context.matched_terms:
                return
            semantic_refs = await self.lookup_term(context, term)
            matches.add_term_matches(term, semantic_refs, True)
            context.matched_terms.add(term)
        else:
            # A related term is matched at most once per query, and a semref
            # already matched by the main term is not double-counted.
            if related_term in context.matched_terms:
                return
            semantic_refs = await self.lookup_term(context, related_term)
            matches.add_term_matches_if_new(
                term, semantic_refs, False, related_term.weight
            )
            context.matched_terms.add(related_term)


class MatchTagExpr(MatchSearchTermExpr):
    def __init__(self, tag_term: SearchTerm):
        self.tag_term = tag_term
        super().__init__(tag_term)

    async def lookup_term(
        self, context: QueryEvalContext, term: Term
    ) -> list[ScoredSemanticRefOrdinal] | None:
        if self.tag_term.term.text == "*":
            return await lookup_knowledge_type(context.semantic_refs, "tag")
        return await lookup_term(
            context.semantic_ref_index,
            term,
            context.semantic_refs,
            context.text_ranges_in_scope,
            "tag",
        )


class MatchTopicExpr(MatchSearchTermExpr):
    def __init__(self, topic: SearchTerm):
        self.topic = topic
        super().__init__(topic)

    async def lookup_term(
        self, context: QueryEvalContext, term: Term
    ) -> list[ScoredSemanticRefOrdinal] | None:
        if self.topic.term.text == "*":
            return await lookup_knowledge_type(context.semantic_refs, "topic")
        return await lookup_term(
            context.semantic_ref_index,
            term,
            context.semantic_refs,
            context.text_ranges_in_scope,
            "topic",
        )


@dataclass
class MatchPropertySearchTermExpr(MatchTermExpr):
    property_search_term: PropertySearchTerm

    async def accumulate_matches(
        self, context: QueryEvalContext, matches: SemanticRefAccumulator
    ) -> None:
        name = self.property_search_term.property_name
        value = self.property_search_term.property_value
        if isinstance(name, str):
            await self.accumulate_matches_for_property(context, name, value, matches)
        else:
            await self.accumulate_matches_for_facets(context, name, value, matches)

    async def accumulate_matches_for_facets(
        self,
        context: QueryEvalContext,
        property_name: SearchTerm,
        property_value: SearchTerm,
        matches: SemanticRefAccumulator,
    ) -> None:
        # Free-form property names match facet names; a non-wildcard value
        # must also match the facet value.
        await self.accumulate_matches_for_property(
            context, PropertyNames.FacetName.value, property_name, matches
        )
        if not is_search_term_wildcard(property_value):
            await self.accumulate_matches_for_property(
                context, PropertyNames.FacetValue.value, property_value, matches
            )

    async def accumulate_matches_for_property(
        self,
        context: QueryEvalContext,
        property_name: str,
        property_value: SearchTerm,
        matches: SemanticRefAccumulator,
    ) -> None:
        await self.accumulate_matches_for_property_value(
            context, matches, property_name, property_value.term
        )
        for related in property_value.related_terms or ():
            await self.accumulate_matches_for_property_value(
                context, matches, property_name, property_value.term, related
            )

    async def accumulate_matches_for_property_value(
        self,
        context: QueryEvalContext,
        matches: SemanticRefAccumulator,
        property_name: str,
        property_value: Term,
        related_prop_val: Term | None = None,
    ) -> None:
        # Dedupe key: which (name, value) actually hits the index.
        effective = related_prop_val if related_prop_val is not None else property_value
        if context.matched_property_terms.has(property_name, effective):
            return
        semantic_refs = await self.lookup_property(
            context, property_name, effective.text
        )
        if not semantic_refs:
            return
        if related_prop_val is None:
            matches.add_term_matches(property_value, semantic_refs, True)
        else:
            matches.add_term_matches_if_new(
                property_value, semantic_refs, False, related_prop_val.weight
            )
        context.matched_property_terms.add(property_name, effective)

    async def lookup_property(
        self, context: QueryEvalContext, property_name: str, property_value: str
    ) -> list[ScoredSemanticRefOrdinal] | None:
        if context.property_index is None:
            return None
        return await lookup_property_in_property_index(
            context.property_index,
            property_name,
            property_value,
            context.semantic_refs,
            context.text_ranges_in_scope,
        )


# ---------------------------------------------------------------------------
# Boolean combinators over term expressions
# ---------------------------------------------------------------------------


class MatchTermsBooleanExpr(QueryOpExpr[SemanticRefAccumulator]):
    """Base for OR / OR-MAX / AND over term expressions."""

    get_scope_expr: "GetScopeExpr | None" = None

    async def begin_match(self, context: QueryEvalContext) -> None:
        if self.get_scope_expr is not None:
            context.text_ranges_in_scope = await self.get_scope_expr.eval(context)
        context.clear_matched_terms()


@dataclass
class MatchTermsOrExpr(MatchTermsBooleanExpr):
    term_expressions: list[IQueryOpExpr[SemanticRefAccumulator | None]] = field(
        default_factory=list
    )
    get_scope_expr: "GetScopeExpr | None" = None

    async def eval(self, context: QueryEvalContext) -> SemanticRefAccumulator:
        await self.begin_match(context)
        union: SemanticRefAccumulator | None = None
        for match_expr in self.term_expressions:
            found = await match_expr.eval(context)
            if not found:
                continue
            if union is None:
                union = found
            else:
                union.add_union(found)
        if union is None:
            return SemanticRefAccumulator()
        union.calculate_total_score()
        return union


@dataclass
class MatchTermsOrMaxExpr(MatchTermsOrExpr):
    """Union, then keep only matches at the max hit count (when > 1)."""

    term_expressions: list[IQueryOpExpr[SemanticRefAccumulator | None]] = field(
        default_factory=list
    )
    get_scope_expr: "GetScopeExpr | None" = None

    async def eval(self, context: QueryEvalContext) -> SemanticRefAccumulator:
        matches = await super().eval(context)
        peak = matches.get_max_hit_count()
        if peak > 1:
            matches.select_with_hit_count(peak)
        return matches


@dataclass
class MatchTermsAndExpr(MatchTermsBooleanExpr):
    term_expressions: list[IQueryOpExpr[SemanticRefAccumulator | None]] = field(
        default_factory=list
    )
    get_scope_expr: "GetScopeExpr | None" = None

    async def eval(self, context: QueryEvalContext) -> SemanticRefAccumulator:
        await self.begin_match(context)
        combined: SemanticRefAccumulator | None = None
        for match_expr in self.term_expressions:
            found = await match_expr.eval(context)
            if not found:
                # Any non-match fails the AND.
                if combined is not None:
                    combined.clear_matches()
                break
            combined = found if combined is None else combined.intersect(found)
        if combined is None:
            return SemanticRefAccumulator()
        combined.calculate_total_score()
        combined.select_with_hit_count(len(self.term_expressions))
        return combined


# ---------------------------------------------------------------------------
# Grouping / filtering expressions
# ---------------------------------------------------------------------------


def to_grouped_search_results(
    eval_results: dict[KnowledgeType, SemanticRefAccumulator],
) -> dict[KnowledgeType, SemanticRefSearchResult]:
    return {
        ktype: SemanticRefSearchResult(
            term_matches=accumulator.search_term_matches,
            semantic_ref_matches=accumulator.to_scored_semantic_refs(),
        )
        for ktype, accumulator in eval_results.items()
        if len(accumulator)
    }


@dataclass
class SelectTopNExpr[T: MatchAccumulator](QueryOpExpr[T]):
    source_expr: IQueryOpExpr[T]
    max_matches: int | None = None
    min_hit_count: int | None = None

    async def eval(self, context: QueryEvalContext) -> T:
        matches = await self.source_expr.eval(context)
        matches.select_top_n_scoring(self.max_matches, self.min_hit_count)
        return matches


@dataclass
class GroupByKnowledgeTypeExpr(
    QueryOpExpr[dict[KnowledgeType, SemanticRefAccumulator]]
):
    matches: IQueryOpExpr[SemanticRefAccumulator]

    async def eval(
        self, context: QueryEvalContext
    ) -> dict[KnowledgeType, SemanticRefAccumulator]:
        accumulator = await self.matches.eval(context)
        return await accumulator.group_matches_by_type(context.semantic_refs)


@dataclass
class SelectTopNKnowledgeGroupExpr(
    QueryOpExpr[dict[KnowledgeType, SemanticRefAccumulator]]
):
    source_expr: IQueryOpExpr[dict[KnowledgeType, SemanticRefAccumulator]]
    max_matches: int | None = None
    min_hit_count: int | None = None

    async def eval(
        self, context: QueryEvalContext
    ) -> dict[KnowledgeType, SemanticRefAccumulator]:
        groups = await self.source_expr.eval(context)
        for accumulator in groups.values():
            accumulator.select_top_n_scoring(self.max_matches, self.min_hit_count)
        return groups


@dataclass
class GroupSearchResultsExpr(
    QueryOpExpr[dict[KnowledgeType, SemanticRefSearchResult]]
):
    src_expr: IQueryOpExpr[dict[KnowledgeType, SemanticRefAccumulator]]

    async def eval(
        self, context: QueryEvalContext
    ) -> dict[KnowledgeType, SemanticRefSearchResult]:
        return to_grouped_search_results(await self.src_expr.eval(context))


class IQuerySemanticRefPredicate(Protocol):
    async def eval(
        self, context: QueryEvalContext, semantic_ref: SemanticRef
    ) -> bool: ...


@dataclass
class KnowledgeTypePredicate(IQuerySemanticRefPredicate):
    knowledge_type: KnowledgeType

    async def eval(self, context: QueryEvalContext, semantic_ref: SemanticRef) -> bool:
        return semantic_ref.knowledge.knowledge_type == self.knowledge_type


@dataclass
class WhereSemanticRefExpr(QueryOpExpr[SemanticRefAccumulator]):
    source_expr: IQueryOpExpr[SemanticRefAccumulator]
    predicates: list[IQuerySemanticRefPredicate]

    async def eval(self, context: QueryEvalContext) -> SemanticRefAccumulator:
        accumulator = await self.source_expr.eval(context)
        kept = SemanticRefAccumulator(set(accumulator.search_term_matches))
        for match in accumulator.get_matches():
            if await self._accept(context, match):
                kept.set_match(match)
        return kept

    async def _accept(
        self, context: QueryEvalContext, match: Match[SemanticRefOrdinal]
    ) -> bool:
        for predicate in self.predicates:
            semantic_ref = await context.get_semantic_ref(match.value)
            if not await predicate.eval(context, semantic_ref):
                return False
        return True


# ---------------------------------------------------------------------------
# Message-side expressions
# ---------------------------------------------------------------------------


async def message_matches_from_knowledge_matches(
    semantic_refs: ISemanticRefCollection,
    knowledge_matches: dict[KnowledgeType, SemanticRefSearchResult],
    intersect_across_knowledge_types: bool = True,
) -> MessageAccumulator:
    """Messages referenced by matched knowledge; kept only if they matched
    every knowledge type that had matches; scores smoothed."""
    message_matches = MessageAccumulator()
    types_with_hits = 0
    for result in knowledge_matches.values():
        if not (result and result.semantic_ref_matches):
            continue
        types_with_hits += 1
        for match in result.semantic_ref_matches:
            ref = await semantic_refs.get_item(match.semantic_ref_ordinal)
            message_matches.add_messages_for_semantic_ref(ref, match.score)
    if intersect_across_knowledge_types and types_with_hits:
        survivors = message_matches.get_with_hit_count(types_with_hits)
        if survivors:
            message_matches = MessageAccumulator(survivors)
    message_matches.smooth_scores()
    return message_matches


@dataclass
class MessagesFromKnowledgeExpr(QueryOpExpr[MessageAccumulator]):
    src_expr: (
        IQueryOpExpr[dict[KnowledgeType, SemanticRefSearchResult]]
        | dict[KnowledgeType, SemanticRefSearchResult]
    )

    async def eval(self, context: QueryEvalContext) -> MessageAccumulator:
        knowledge = (
            self.src_expr
            if isinstance(self.src_expr, dict)
            else await self.src_expr.eval(context)
        )
        return await message_matches_from_knowledge_matches(
            context.semantic_refs, knowledge
        )


@dataclass
class GetScoredMessagesExpr(QueryOpExpr[list[ScoredMessageOrdinal]]):
    src_expr: IQueryOpExpr[MessageAccumulator]

    async def eval(self, context: QueryEvalContext) -> list[ScoredMessageOrdinal]:
        matches = await self.src_expr.eval(context)
        return matches.to_scored_message_ordinals()


@dataclass
class SelectMessagesInCharBudget(QueryOpExpr[MessageAccumulator]):
    src_expr: IQueryOpExpr[MessageAccumulator]
    max_chars: int

    async def eval(self, context: QueryEvalContext) -> MessageAccumulator:
        matches = await self.src_expr.eval(context)
        await matches.select_messages_in_budget(context.messages, self.max_chars)
        return matches


@dataclass
class RankMessagesBySimilarityExpr(QueryOpExpr[MessageAccumulator]):
    """Re-rank candidate messages against the raw query embedding via the
    message index's subset lookup (gather + matmul on the store's device)."""

    src_expr: IQueryOpExpr[MessageAccumulator]
    embedding: np.ndarray
    max_messages: int | None = None
    threshold_score: float | None = None

    async def eval(self, context: QueryEvalContext) -> MessageAccumulator:
        matches = await self.src_expr.eval(context)
        if self.max_messages is not None and len(matches) <= self.max_messages:
            return matches

        from ..storage.memory.messageindex import IMessageTextEmbeddingIndex

        secondary = context.conversation.secondary_indexes
        message_index = secondary.message_index if secondary else None
        if isinstance(message_index, IMessageTextEmbeddingIndex):
            ordinals = await self._ordinals_in_index(message_index, matches)
            if len(ordinals) == len(matches):
                # Async route when available: the device fetch runs off-loop
                # so concurrent query() pipelines overlap their re-rank
                # round trips instead of serializing on the event loop.
                lookup_async = getattr(
                    message_index, "lookup_in_subset_by_embedding_async", None
                )
                if lookup_async is not None:
                    ranked = await lookup_async(
                        self.embedding,
                        ordinals,
                        self.max_messages,
                        self.threshold_score,
                    )
                else:
                    ranked = message_index.lookup_in_subset_by_embedding(
                        self.embedding,
                        ordinals,
                        self.max_messages,
                        self.threshold_score,
                    )
                matches.clear_matches()
                for scored in ranked:
                    matches.add(scored.message_ordinal, scored.score)
                return matches

        # Index unavailable (or candidates not fully indexed): plain top-N.
        if self.max_messages is not None:
            matches.select_top_n_scoring(self.max_messages)
        return matches

    async def _ordinals_in_index(
        self, message_index, matches: MessageAccumulator
    ) -> list[MessageOrdinal]:
        index_size = await message_index.size()
        ordinals: list[MessageOrdinal] = []
        for ordinal in matches.get_matched_values():
            if ordinal >= index_size:
                break
            ordinals.append(ordinal)
        return ordinals


@dataclass
class MatchMessagesBooleanExpr(IQueryOpExpr[MessageAccumulator]):
    term_expressions: list[
        IQueryOpExpr[SemanticRefAccumulator | MessageAccumulator | None]
    ]

    def _begin_match(self, context: QueryEvalContext) -> None:
        context.clear_matched_terms()

    async def _as_message_matches(
        self,
        context: QueryEvalContext,
        found: SemanticRefAccumulator | MessageAccumulator,
    ) -> MessageAccumulator:
        if isinstance(found, MessageAccumulator):
            return found
        message_matches = MessageAccumulator()
        for match in found:
            ref = await context.get_semantic_ref(match.value)
            message_matches.add_messages_for_semantic_ref(ref, match.score)
        return message_matches


@dataclass
class MatchMessagesOrExpr(MatchMessagesBooleanExpr):
    async def eval(self, context: QueryEvalContext) -> MessageAccumulator:
        self._begin_match(context)
        union: MessageAccumulator | None = None
        for match_expr in self.term_expressions:
            found = await match_expr.eval(context)
            if not found:
                continue
            message_matches = await self._as_message_matches(context, found)
            if union is None:
                union = message_matches
            else:
                union.add_union(message_matches)
        if union is None:
            return MessageAccumulator()
        union.calculate_total_score()
        return union


@dataclass
class MatchMessagesOrMaxExpr(MatchMessagesOrExpr):
    async def eval(self, context: QueryEvalContext) -> MessageAccumulator:
        matches = await super().eval(context)
        peak = matches.get_max_hit_count()
        if peak > 1:
            matches.select_with_hit_count(peak)
        return matches


@dataclass
class MatchMessagesAndExpr(MatchMessagesBooleanExpr):
    async def eval(self, context: QueryEvalContext) -> MessageAccumulator:
        self._begin_match(context)
        combined: MessageAccumulator | None = None
        for match_expr in self.term_expressions:
            found = await match_expr.eval(context)
            if not found:
                return MessageAccumulator()  # any non-match fails the AND
            message_matches = await self._as_message_matches(context, found)
            if combined is None:
                combined = message_matches
            else:
                combined = combined.intersect(message_matches)
                if not combined:
                    return MessageAccumulator()
        if combined is None:
            return MessageAccumulator()
        combined.calculate_total_score()
        combined.select_with_hit_count(len(self.term_expressions))
        return combined
