"""Query compiler: SearchTermGroup + WhenFilter -> expression tree.

(Parity: reference knowpro/search.py. Compile rules preserved:
  * entity term match weight 100.0, default 10.0; related terms scoring at or
    above 0.95 weight are treated as exact-weight (`search.py:200-213`);
  * term text is lowercased during validation;
  * entity matches boosted x(entity/default weight) when the term matches the
    entity's name or type;
  * action property terms (subject/verb/object/indirectObject) become scope
    selectors when no explicit scope terms are given;
  * non-exact queries resolve related terms over select (dedupe) + predicate +
    scope term groups.)

The port of ``typeagent_tpu/knowpro/search.py``. As in the JAX package,
``SearchOptions(use_device_executor=...)`` picks the stage-3 engine, by
default the device engine (``knowpro/device_executor.py``, through the
``EngineBatcher`` of ``knowpro/engine_batcher.py``): True / "device" the
device engine, False / "host" the host VM (``knowpro/query.py``), "auto"
the faster of the two by measured latency; the default is read from
``TAT_ENGINE_ROUTE`` (device|host|auto) when the options are made. A query
the engine cannot express (``None`` from it) runs on the host VM and the
conversation notes the route "host (device fallback)", as in JAX: that is
routing by the query's shape. One deliberate departure: the JAX package
catches any engine exception and answers from the host VM; the port does
not, so a launch failure, an out-of-memory or a wrong device propagates to
the caller instead of hiding behind a host answer.

Besides the JAX package's ``search.knowledge`` span (stage 3, on either engine),
the port records ``search.compile`` (the knowledge query's compile, related
terms resolved) and ``search.messages`` (the message query: its compile,
the embedding re-rank and its run), so that a query's time can be split
by stage.
"""

from __future__ import annotations

import asyncio
import os
import time
from collections.abc import Callable
from dataclasses import field
from typing import TYPE_CHECKING, TypeGuard, cast

if TYPE_CHECKING:
    from .device_executor import DeviceQueryExecutor
    from .engine_batcher import EngineBatcher

from ..storage.memory.messageindex import IMessageTextEmbeddingIndex
from ..storage.memory.reltermsindex import resolve_related_terms
from ..utils.trace import span
from .collections import MessageAccumulator, SemanticRefAccumulator
from .fields import dataclass
from .interfaces import (
    IConversation,
    IConversationSecondaryIndexes,
    KnowledgeType,
    PropertySearchTerm,
    ScoredMessageOrdinal,
    ScoredSemanticRefOrdinal,
    SearchSelectExpr,
    SearchTerm,
    SearchTermGroup,
    SemanticRef,
    SemanticRefSearchResult,
    Term,
    WhenFilter,
)
from .kplib import ConcreteEntity
from .query import (
    BooleanOp,
    CompiledSearchTerm,
    CompiledTermGroup,
    GetScopeExpr,
    GetScoredMessagesExpr,
    GroupByKnowledgeTypeExpr,
    GroupSearchResultsExpr,
    IQueryOpExpr,
    IQuerySemanticRefPredicate,
    IQueryTextRangeSelector,
    KnowledgeTypePredicate,
    MatchMessagesAndExpr,
    MatchMessagesBooleanExpr,
    MatchMessagesOrExpr,
    MatchMessagesOrMaxExpr,
    MatchPropertySearchTermExpr,
    MatchSearchTermExpr,
    MatchTagExpr,
    MatchTermsAndExpr,
    MatchTermsBooleanExpr,
    MatchTermsOrExpr,
    MatchTermsOrMaxExpr,
    MatchTopicExpr,
    MessagesFromKnowledgeExpr,
    NoOpExpr,
    QueryEvalContext,
    RankMessagesBySimilarityExpr,
    SelectMessagesInCharBudget,
    SelectTopNExpr,
    SelectTopNKnowledgeGroupExpr,
    TextRangeSelector,
    TextRangesFromMessagesSelector,
    TextRangesInDateRangeSelector,
    ThreadSelector,
    WhereSemanticRefExpr,
    is_conversation_searchable,
    match_entity_name_or_type,
    to_non_required_search_term,
    to_required_search_term,
)
from .searchlib import create_tag_search_term_group

# Scope-defining action property names (S.V.O. of an ActionTerm).
_ACTION_PROPERTY_NAMES = ("subject", "verb", "object", "indirectObject")


def is_property_term(term: SearchTerm) -> TypeGuard[PropertySearchTerm]:
    return isinstance(term, PropertySearchTerm)


def is_action_property_term(term: PropertySearchTerm) -> bool:
    # Facet-style property names are SearchTerm objects, never action props.
    return (
        isinstance(term.property_name, str)
        and term.property_name in _ACTION_PROPERTY_NAMES
    )


# ---------------------------------------------------------------------------
# Boolean-expression factories
# ---------------------------------------------------------------------------

_TERM_BOOL_EXPRS: dict[BooleanOp, type[MatchTermsBooleanExpr]] = {
    "and": MatchTermsAndExpr,
    "or": MatchTermsOrExpr,
    "or_max": MatchTermsOrMaxExpr,
}
_MESSAGE_BOOL_EXPRS: dict[BooleanOp, type[MatchMessagesBooleanExpr]] = {
    "and": MatchMessagesAndExpr,
    "or": MatchMessagesOrExpr,
    "or_max": MatchMessagesOrMaxExpr,
}


def create_match_terms_boolean_expr(
    term_expressions: list[IQueryOpExpr[SemanticRefAccumulator | None]],
    boolean_op: BooleanOp,
    scope_expr: GetScopeExpr | None = None,
) -> MatchTermsBooleanExpr:
    try:
        return _TERM_BOOL_EXPRS[boolean_op](term_expressions, scope_expr)
    except KeyError:
        raise ValueError(f"Unknown boolean op: {boolean_op}") from None


def create_match_messages_boolean_expr(
    term_expressions: list[
        IQueryOpExpr[SemanticRefAccumulator | MessageAccumulator | None]
    ],
    boolean_op: BooleanOp,
    scope_expr: GetScopeExpr | None = None,
) -> MatchMessagesBooleanExpr:
    try:
        return _MESSAGE_BOOL_EXPRS[boolean_op](term_expressions)
    except KeyError:
        raise ValueError(f"Unknown boolean op: {boolean_op}") from None


# ---------------------------------------------------------------------------
# Public result/option types
# ---------------------------------------------------------------------------


@dataclass
class SearchQueryExpr:
    """Compiled form of a natural-language search query."""

    select_expressions: list[SearchSelectExpr]
    raw_query: str | None = None


def _default_engine_route() -> bool | str:
    """``TAT_ENGINE_ROUTE`` as a ``use_device_executor`` value: the device
    engine (True) unless it says host or auto. Read when ``SearchOptions``
    are made."""
    v = os.environ.get("TAT_ENGINE_ROUTE", "").strip().lower()
    if v == "auto":
        return "auto"
    if v in ("host", "vm", "0", "false"):
        return False
    return True


def _route_device(value: bool | str) -> bool:
    """Resolve a non-"auto" ``use_device_executor`` value to a route.

    Accepts the same vocabulary as TAT_ENGINE_ROUTE so callers can pass
    the strings directly — ``bool("host")`` is True, so a bare bool() cast
    would silently run the DEVICE engine for an explicit host request.
    """
    if isinstance(value, str):
        return value.strip().lower() not in ("host", "vm", "0", "false", "")
    return bool(value)


class _EngineRouter:
    """Latency-adaptive device-vs-host routing for ``use_device_executor="auto"``.

    Both engines return the same results (pinned by the differential
    suites), so routing is purely a latency decision. Per conversation:
    sample each engine once, then follow the faster EMA while re-probing
    the slower one periodically — latency shifts with conversation growth.
    """

    PROBE_EVERY = 32
    ALPHA = 0.3

    def __init__(self) -> None:
        self.ms: dict[str, float | None] = {"device": None, "host": None}
        self.calls = 0

    def pick(self) -> str:
        self.calls += 1
        if self.ms["device"] is None:
            return "device"
        if self.ms["host"] is None:
            return "host"
        fast = "device" if self.ms["device"] <= self.ms["host"] else "host"
        if self.calls % self.PROBE_EVERY == 0:
            return "host" if fast == "device" else "device"
        return fast

    def record(self, engine: str, ms: float) -> None:
        cur = self.ms[engine]
        self.ms[engine] = (
            ms if cur is None else (1.0 - self.ALPHA) * cur + self.ALPHA * ms
        )


def _note_route(conversation: IConversation, route: str) -> None:
    """Record the engine route the last search actually took (for @stage 3
    REPL introspection and tests); best-effort on slots-only objects."""
    try:
        conversation._last_engine_route = route  # type: ignore[attr-defined]
    except AttributeError:
        pass


def _engine_router(conversation: IConversation) -> _EngineRouter | None:
    router = getattr(conversation, "_engine_router", None)
    if router is None:
        router = _EngineRouter()
        try:
            conversation._engine_router = router  # type: ignore[attr-defined]
        except AttributeError:
            return None  # slots-only conversations: route statically
    return router


def _pick_route(
    conversation: IConversation, options: SearchOptions
) -> tuple[bool, _EngineRouter | None]:
    """(run the device engine?, the "auto" router or None)."""
    if options.use_device_executor == "auto":
        router = _engine_router(conversation)
        if router is not None:
            return router.pick() == "device", router
    return _route_device(options.use_device_executor), None


@dataclass
class SearchOptions:
    max_knowledge_matches: int | None = None
    exact_match: bool = False
    max_message_matches: int | None = None
    # Cumulative character cap for selected messages.
    max_chars_in_budget: int | None = None
    threshold_score: float | None = None
    # Default engine: run the compiled knowledge query on the device engine
    # (knowpro/device_executor.py) — related terms, scopes, boolean groups,
    # wildcards and the entity boost included; a query it can't express
    # runs on the host VM. "auto" routes adaptively by measured latency
    # (both engines return the same results); False / "host" is the host
    # VM. Env default: TAT_ENGINE_ROUTE=device|host|auto, device when unset.
    use_device_executor: bool | str = field(default_factory=_default_engine_route)

    def __repr__(self) -> str:
        set_fields = (
            (name, value)
            for name, value in vars(self).items()
            if value is not None and not name.startswith("_")
        )
        inner = ", ".join(f"{name}={value!r}" for name, value in set_fields)
        return f"{type(self).__name__}({inner})"


@dataclass
class ConversationSearchResult:
    message_matches: list[ScoredMessageOrdinal]
    knowledge_matches: dict[KnowledgeType, SemanticRefSearchResult]
    raw_query_text: str | None = None


def has_conversation_result(result: ConversationSearchResult) -> bool:
    return bool(result.knowledge_matches or result.message_matches)


def has_conversation_results(results: list[ConversationSearchResult]) -> bool:
    return any(map(has_conversation_result, results))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


async def run_query[T](
    conversation: IConversation,
    options: SearchOptions | None,
    query: IQueryOpExpr[T],
) -> T:
    indexes = conversation.secondary_indexes
    assert indexes is not None, (
        "Conversation secondary indexes must be initialized before running queries"
    )
    context = QueryEvalContext(
        conversation,
        indexes.property_to_semantic_ref_index,
        indexes.timestamp_index,
    )
    return await query.eval(context)


async def search_conversation_knowledge(
    conversation: IConversation,
    search_term_group: SearchTermGroup,
    when_filter: WhenFilter | None = None,
    options: SearchOptions | None = None,
) -> dict[KnowledgeType, SemanticRefSearchResult] | None:
    options = options or SearchOptions()
    if not is_conversation_searchable(conversation):
        return None
    assert conversation.secondary_indexes is not None, (
        "Conversation secondary indexes must be initialized before searching"
    )
    compiler = QueryCompiler(conversation, conversation.secondary_indexes)
    with span("search.compile"):
        knowledge_query = await compiler.compile_knowledge_query(
            search_term_group, when_filter, options
        )
    route_device, router = _pick_route(conversation, options)
    t_dev = None
    if route_device:
        # No except here (the module docstring): an engine error propagates.
        with span("search.knowledge", route="device"):
            t_dev = time.perf_counter()
            device_result = await _try_device_executor(
                conversation, knowledge_query, options
            )
        if device_result is not None:
            if router is not None:
                router.record("device", (time.perf_counter() - t_dev) * 1000.0)
            _note_route(conversation, "device")
            return device_result
    with span("search.knowledge", route="host"):
        t0 = time.perf_counter()
        _note_route(
            conversation, "host (device fallback)" if t_dev is not None else "host"
        )
        result = await run_query(conversation, options, knowledge_query)
        if router is not None:
            router.record("host", (time.perf_counter() - t0) * 1000.0)
            if t_dev is not None:
                # The device engine could not express the query and we paid
                # attempt + fallback: record that as the device sample, or
                # ms["device"] stays None and pick() retries it forever.
                router.record("device", (time.perf_counter() - t_dev) * 1000.0)
        return result


async def search_conversation_knowledge_batch(
    conversation: IConversation,
    selects: list[tuple[SearchTermGroup, WhenFilter | None]],
    options: SearchOptions | None = None,
) -> list[dict[KnowledgeType, SemanticRefSearchResult] | None]:
    """Knowledge matches for MANY term groups in fused device calls.

    All expressible queries' term lookups run as one segmented device
    program (knowpro/device_executor.py); inexpressible ones run on the
    host VM individually. The reference has no batch analogue — its VM
    evaluates queries strictly one at a time.
    """
    options = options or SearchOptions()
    if not is_conversation_searchable(conversation):
        return [None] * len(selects)
    assert conversation.secondary_indexes is not None
    compiled = []
    with span("search.compile", batch=len(selects)):
        for search_term_group, when_filter in selects:
            compiler = QueryCompiler(conversation, conversation.secondary_indexes)
            compiled.append(
                await compiler.compile_knowledge_query(
                    search_term_group, when_filter, options
                )
            )
    results: list[dict[KnowledgeType, SemanticRefSearchResult] | None] = [None] * len(selects)
    route_device, router = _pick_route(conversation, options)
    t_dev = None
    device_done = 0
    if route_device:
        # No except here (the module docstring): an engine error propagates.
        with span("search.knowledge", route="device", batch=len(selects)):
            t_dev = time.perf_counter()
            results = list(await _execute_on_device(conversation, compiled))
            device_done = sum(1 for r in results if r is not None)
            if router is not None and device_done:
                # Mixed batches (some queries device-inexpressible) must
                # still record a sample, or ms["device"] stays None forever
                # and pick() never probes the host.
                router.record(
                    "device", (time.perf_counter() - t_dev) * 1000.0 / device_done
                )
    host_t0 = time.perf_counter()
    host_ran = 0
    for i, knowledge_query in enumerate(compiled):
        if results[i] is None:
            host_ran += 1
            with span("search.knowledge", route="host"):
                results[i] = await run_query(conversation, options, knowledge_query)
    if router is not None and host_ran:
        router.record("host", (time.perf_counter() - host_t0) * 1000.0 / host_ran)
        if t_dev is not None and not device_done:
            # Every query fell back: charge the device the attempt +
            # fallback so the router can converge to the host.
            router.record("device", (time.perf_counter() - t_dev) * 1000.0 / host_ran)
    if device_done and host_ran:
        _note_route(conversation, f"mixed (device {device_done}, host {host_ran})")
    elif device_done:
        _note_route(conversation, "device")
    else:
        _note_route(
            conversation, "host (device fallback)" if t_dev is not None else "host"
        )
    return results


async def search_conversation(
    conversation: IConversation,
    search_term_group: SearchTermGroup,
    when_filter: WhenFilter | None = None,
    options: SearchOptions | None = None,
    raw_search_query: str | None = None,
) -> ConversationSearchResult | None:
    """Knowledge matches + message matches for one term group."""
    options = options or SearchOptions()
    knowledge_matches = await search_conversation_knowledge(
        conversation, search_term_group, when_filter, options
    )
    if knowledge_matches is None:
        return None
    with span("search.messages"):
        compiler = QueryCompiler(conversation, conversation.secondary_indexes)
        message_query = await compiler.compile_message_query(
            knowledge_matches, options, raw_search_query
        )
        message_matches: list[ScoredMessageOrdinal] = await run_query(
            conversation, options, message_query
        )
    return ConversationSearchResult(
        message_matches, knowledge_matches, raw_search_query
    )


async def run_search_query(
    conversation: IConversation,
    query: SearchQueryExpr,
    options: SearchOptions | None = None,
    original_query_text: str | None = None,
) -> list[ConversationSearchResult]:
    options = options or SearchOptions()
    raw_text = original_query_text or query.raw_query
    if not is_conversation_searchable(conversation):
        return []
    selects = [
        (expr.search_term_group, expr.when) for expr in query.select_expressions
    ]
    knowledge_results = await search_conversation_knowledge_batch(
        conversation, selects, options
    )
    results: list[ConversationSearchResult] = []
    for knowledge_matches in knowledge_results:
        if knowledge_matches is None:
            continue
        with span("search.messages"):
            compiler = QueryCompiler(conversation, conversation.secondary_indexes)
            message_query = await compiler.compile_message_query(
                knowledge_matches, options, raw_text
            )
            message_matches: list[ScoredMessageOrdinal] = await run_query(
                conversation, options, message_query
            )
        results.append(
            ConversationSearchResult(message_matches, knowledge_matches, raw_text)
        )
    return results


async def _get_device_executor(
    conversation: IConversation,
) -> tuple[DeviceQueryExecutor, QueryEvalContext]:
    """Cached per-conversation device executor + an eval context.

    Always returns a live (executor, context) pair — conversations that
    forbid attribute caching just rebuild the executor per call. The
    executor re-syncs (incrementally) when semrefs were appended.
    """
    from .device_executor import DeviceQueryExecutor

    executor = getattr(conversation, "_device_executor", None)
    semref_count = await conversation.semantic_refs.size()
    if executor is None:
        executor = DeviceQueryExecutor(conversation)
        await executor.sync()
        try:
            conversation._device_executor = executor  # type: ignore[attr-defined]
            conversation._device_executor_count = semref_count  # type: ignore[attr-defined]
        except AttributeError:
            pass  # conversation objects that forbid new attributes
    elif getattr(conversation, "_device_executor_count", -1) != semref_count:
        # Incremental: fold only the new semrefs into the device postings.
        await executor.sync()
        try:
            conversation._device_executor_count = semref_count  # type: ignore[attr-defined]
        except AttributeError:
            pass
    indexes = conversation.secondary_indexes
    context = QueryEvalContext(
        conversation,
        indexes.property_to_semantic_ref_index if indexes else None,
        indexes.timestamp_index if indexes else None,
    )
    return executor, context


def _engine_coalesce_enabled() -> bool:
    """TAT_ENGINE_COALESCE=0 disables cross-call dispatch coalescing; read
    per call, so that one process can compare both."""
    return os.environ.get("TAT_ENGINE_COALESCE", "1") == "1"


def _get_engine_batcher(conversation: IConversation) -> EngineBatcher:
    """Per-(conversation, event-loop) EngineBatcher.

    A batcher's worker task dies with its event loop, so loop turnover
    (every test, every asyncio.run) gets a fresh batcher; within one loop
    all concurrent searches against the conversation share one."""
    from .engine_batcher import EngineBatcher

    loop = asyncio.get_running_loop()
    batcher = getattr(conversation, "_engine_batcher", None)
    if batcher is None or batcher.loop not in (None, loop):
        batcher = EngineBatcher(conversation, _get_device_executor)
        try:
            conversation._engine_batcher = batcher  # type: ignore[attr-defined]
        except AttributeError:
            pass  # uncacheable conversation: batcher lives for this call only
    return batcher


async def _execute_on_device(
    conversation: IConversation, compiled: list[GroupSearchResultsExpr]
) -> list[dict[KnowledgeType, SemanticRefSearchResult] | None]:
    """Run compiled stage-3 queries on the device engine, coalescing with
    concurrent callers' dispatches when enabled (knowpro/engine_batcher.py)."""
    if _engine_coalesce_enabled():
        return await _get_engine_batcher(conversation).execute_batch(compiled)
    executor, context = await _get_device_executor(conversation)
    return await executor.execute_batch(compiled, context)


async def _try_device_executor(
    conversation: IConversation,
    knowledge_query: GroupSearchResultsExpr,
    options: SearchOptions,
) -> dict[KnowledgeType, SemanticRefSearchResult] | None:
    """One compiled query on the device engine; None = the engine cannot
    express it (the caller runs the host VM).

    Evaluates the SAME compiled query tree the host VM would run, so the
    device route sees identical weights, related terms, boosters and scopes.
    """
    return (await _execute_on_device(conversation, [knowledge_query]))[0]


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------

# NOTE: QueryCompiler instances are stateful and not thread-safe; create a
# fresh one per query.
class QueryCompiler:
    # Compile-rule weights (reference search.py:200-213).
    ENTITY_TERM_WEIGHT = 100.0
    DEFAULT_TERM_WEIGHT = 10.0
    RELATED_IS_EXACT_THRESHOLD = 0.95

    def __init__(
        self,
        conversation: IConversation,
        secondary_indexes: IConversationSecondaryIndexes | None,
        entity_term_match_weight: float = ENTITY_TERM_WEIGHT,
        default_term_match_weight: float = DEFAULT_TERM_WEIGHT,
        related_is_exact_threshold: float = RELATED_IS_EXACT_THRESHOLD,
    ):
        self.conversation = conversation
        self.secondary_indexes = secondary_indexes
        self.entity_term_match_weight = entity_term_match_weight
        self.default_term_match_weight = default_term_match_weight
        self.related_is_exact_threshold = related_is_exact_threshold
        # Term groups gathered during compilation, for related-term resolution.
        self.all_search_terms: list[CompiledTermGroup] = []
        self.all_predicate_search_terms: list[CompiledTermGroup] = []
        self.all_scope_search_terms: list[CompiledTermGroup] = []

    # -- top-level compiles ---------------------------------------------------

    async def compile_knowledge_query(
        self,
        terms: SearchTermGroup,
        filter: WhenFilter | None = None,
        options: SearchOptions | None = None,
    ) -> GroupSearchResultsExpr:
        query = await self.compile_query(terms, filter, options)
        if not (options.exact_match if options else False):
            # Non-exact queries expand terms through aliases + the fuzzy index.
            await self.resolve_related_terms(self.all_search_terms, True)
            await self.resolve_related_terms(self.all_predicate_search_terms, False)
            await self.resolve_related_terms(self.all_scope_search_terms, False)
        return GroupSearchResultsExpr(query)

    async def compile_query(
        self,
        search_term_group: SearchTermGroup,
        filter: WhenFilter | None = None,
        options: SearchOptions | None = None,
    ) -> IQueryOpExpr[dict[KnowledgeType, SemanticRefAccumulator]]:
        scope = await self.compile_scope(search_term_group, filter)
        select_expr = self.compile_select(search_term_group, scope, options)
        if filter:
            select_expr = WhereSemanticRefExpr(select_expr, self.compile_where(filter))
        top_n = options.max_knowledge_matches if options else None
        return SelectTopNKnowledgeGroupExpr(
            GroupByKnowledgeTypeExpr(select_expr), top_n or None
        )

    async def compile_message_query(
        self,
        knowledge: (
            IQueryOpExpr[dict[KnowledgeType, SemanticRefSearchResult]]
            | dict[KnowledgeType, SemanticRefSearchResult]
        ),
        options: SearchOptions | None = None,
        raw_query_text: str | None = None,
    ) -> GetScoredMessagesExpr:
        query: IQueryOpExpr = MessagesFromKnowledgeExpr(knowledge)
        if options is not None:
            query = await self.compile_message_re_rank(query, raw_query_text, options)
            budget = options.max_chars_in_budget
            if budget and budget > 0:
                query = SelectMessagesInCharBudget(query, budget)
        return GetScoredMessagesExpr(query)

    # -- select compilation ----------------------------------------------------

    def compile_select(
        self,
        term_group: SearchTermGroup,
        scope_expr: GetScopeExpr | None = None,
        options: SearchOptions | None = None,
    ) -> IQueryOpExpr[SemanticRefAccumulator]:
        used, select_expr = self.compile_search_group_terms(term_group, scope_expr)
        self.all_search_terms.extend(used)
        return select_expr

    def compile_search_group_terms(
        self,
        search_group: SearchTermGroup,
        scope_expr: GetScopeExpr | None = None,
    ) -> tuple[list[CompiledTermGroup], IQueryOpExpr[SemanticRefAccumulator]]:
        return self.compile_search_group(
            search_group, create_match_terms_boolean_expr, scope_expr
        )

    def compile_search_group_messages(
        self, search_group: SearchTermGroup
    ) -> tuple[list[CompiledTermGroup], IQueryOpExpr[MessageAccumulator]]:
        return self.compile_search_group(
            search_group, create_match_messages_boolean_expr
        )

    def compile_search_group(
        self,
        search_group: SearchTermGroup,
        create_op: Callable[
            [list[IQueryOpExpr], BooleanOp, GetScopeExpr | None],
            IQueryOpExpr,
        ],
        scope_expr: GetScopeExpr | None = None,
    ) -> tuple[list[CompiledTermGroup], IQueryOpExpr]:
        this_level: list[CompiledSearchTerm] = []
        groups: list[CompiledTermGroup] = [
            CompiledTermGroup(boolean_op=search_group.boolean_op, terms=this_level)
        ]
        exprs: list[IQueryOpExpr] = []
        for term in search_group.terms:
            match term:
                case PropertySearchTerm():
                    exprs.append(self.compile_property_term(term))
                    # Free-form (facet) property names also resolve as terms;
                    # both halves keep whatever related terms they carry.
                    if not isinstance(term.property_name, str):
                        this_level.append(to_required_search_term(term.property_name))
                    this_level.append(to_required_search_term(term.property_value))
                case SearchTermGroup():
                    nested, expr = self.compile_search_group(term, create_op)
                    groups.extend(nested)
                    exprs.append(expr)
                case _:
                    exprs.append(self.compile_search_term(term))
                    this_level.append(to_non_required_search_term(term))
        return groups, create_op(exprs, search_group.boolean_op, scope_expr)

    def compile_search_term(
        self, term: SearchTerm
    ) -> IQueryOpExpr[SemanticRefAccumulator | None]:
        boost = self.entity_term_match_weight / self.default_term_match_weight

        def booster(t: SearchTerm, sr: SemanticRef, scored: ScoredSemanticRefOrdinal):
            return self.boost_entities(t, sr, scored, boost)

        expr = MatchSearchTermExpr(term, booster)
        # Declared boost factor lets the device executor replicate the boost
        # via name/type property membership instead of per-ref callbacks.
        expr.entity_boost_factor = boost
        return expr

    def compile_property_term(
        self, term: PropertySearchTerm
    ) -> IQueryOpExpr[SemanticRefAccumulator | None]:
        name = term.property_name
        if name == "tag":
            return MatchTagExpr(term.property_value)
        if name == "topic":
            return MatchTopicExpr(term.property_value)
        if name in ("name", "type") and term.property_value.term.weight is None:
            # Entity name/type matches carry the entity weight.
            term.property_value.term.weight = self.entity_term_match_weight
        return MatchPropertySearchTermExpr(term)

    # -- scope compilation -------------------------------------------------------

    async def compile_scope(
        self,
        term_group: SearchTermGroup | None = None,
        filter: WhenFilter | None = None,
    ) -> GetScopeExpr | None:
        selectors: list[IQueryTextRangeSelector] = []

        if filter and filter.date_range:
            selectors.append(TextRangesInDateRangeSelector(filter.date_range))

        # 'OUTER' scope: explicit scope terms win; otherwise any action terms
        # present in the select group become the scope.
        explicit = filter.scope_defining_terms if filter else None
        if explicit is not None:
            self.add_terms_scope_selector(explicit, selectors)
        elif term_group is not None:
            action_group = self.get_action_terms_from_search_group(term_group)
            if action_group is not None:
                self.add_terms_scope_selector(action_group, selectors)

        if filter and filter.text_ranges_in_scope:
            selectors.append(TextRangeSelector(filter.text_ranges_in_scope))

        if filter and filter.tags:
            self.add_terms_scope_selector(
                create_tag_search_term_group(filter.tags), selectors
            )

        threads = self.secondary_indexes.threads if self.secondary_indexes else None
        if threads and filter and filter.thread_description:
            matching = await threads.lookup_thread(filter.thread_description)
            if matching:
                selectors.append(
                    ThreadSelector(
                        [threads.threads[t.thread_ordinal] for t in matching]
                    )
                )

        return GetScopeExpr(selectors) if selectors else None

    def add_terms_scope_selector(
        self,
        term_group: SearchTermGroup,
        scope_selectors: list[IQueryTextRangeSelector],
    ) -> None:
        if not term_group.terms:
            return
        used, select_expr = self.compile_search_group_messages(term_group)
        scope_selectors.append(TextRangesFromMessagesSelector(select_expr))
        self.all_scope_search_terms.extend(used)

    def get_action_terms_from_search_group(
        self, search_group: SearchTermGroup
    ) -> SearchTermGroup | None:
        action_terms = [
            term
            for term in search_group.terms
            if is_property_term(term) and is_action_property_term(term)
        ]
        if not action_terms:
            return None
        return SearchTermGroup(boolean_op="and", terms=list(action_terms))

    def compile_where(self, filter: WhenFilter) -> list[IQuerySemanticRefPredicate]:
        if filter.knowledge_type:
            return [KnowledgeTypePredicate(filter.knowledge_type)]
        return []

    # -- message re-rank ---------------------------------------------------------

    async def compile_message_re_rank(
        self,
        src_expr: IQueryOpExpr,
        raw_query_text: str | None = None,
        options: SearchOptions | None = None,
    ) -> IQueryOpExpr:
        indexes = self.conversation.secondary_indexes
        message_index = indexes.message_index if indexes else None
        can_re_rank = (
            raw_query_text is not None
            and isinstance(message_index, IMessageTextEmbeddingIndex)
            and not await message_index.is_empty()
        )
        if can_re_rank:
            embedding = await message_index.generate_embedding(raw_query_text)
            return RankMessagesBySimilarityExpr(
                src_expr,
                embedding,
                options.max_message_matches if options else None,
                options.threshold_score if options else None,
            )
        max_messages = options.max_message_matches if options else None
        if max_messages and max_messages > 0:
            return SelectTopNExpr(src_expr, max_messages)
        return NoOpExpr(src_expr)

    # -- term preparation ---------------------------------------------------------

    async def resolve_related_terms(
        self,
        compiled_terms: list[CompiledTermGroup],
        dedupe: bool,
        filter: WhenFilter | None = None,
    ) -> None:
        if not compiled_terms:
            return
        for group in compiled_terms:
            self.validate_and_prepare_search_terms(group.terms)
        index = (
            self.secondary_indexes.term_to_related_terms_index
            if self.secondary_indexes
            else None
        )
        if index is not None:
            await resolve_related_terms(index, compiled_terms, dedupe)
            # Resolution may have added related terms: prepare those too.
            for group in compiled_terms:
                self.validate_and_prepare_search_terms(group.terms)

    def validate_and_prepare_search_terms(
        self, terms: list[CompiledSearchTerm]
    ) -> None:
        for term in terms:
            self.validate_and_prepare_search_term(term)

    def validate_and_prepare_search_term(
        self, search_term: CompiledSearchTerm
    ) -> bool:
        if not self.validate_and_prepare_term(search_term.term):
            return False
        # Exact matches count more than related matches, so the main term
        # gets the default weight when none was assigned.
        if search_term.term.weight is None:
            search_term.term.weight = self.default_term_match_weight
        for related in search_term.related_terms or ():
            if not self.validate_and_prepare_term(related):
                return False
            # A related term nearly identical to the main term scores the same.
            if (
                related.weight is not None
                and related.weight >= self.related_is_exact_threshold
            ):
                related.weight = self.default_term_match_weight
        return True

    def validate_and_prepare_term(self, term: Term | None) -> bool:
        if term:
            term.text = term.text.lower()
        return True

    def boost_entities(
        self,
        search_term: SearchTerm,
        sr: SemanticRef,
        scored_ref: ScoredSemanticRefOrdinal,
        boost_weight: float,
    ) -> ScoredSemanticRefOrdinal:
        if sr.knowledge.knowledge_type != "entity":
            return scored_ref
        if not match_entity_name_or_type(
            search_term, cast(ConcreteEntity, sr.knowledge)
        ):
            return scored_ref
        return ScoredSemanticRefOrdinal(
            scored_ref.semantic_ref_ordinal, scored_ref.score * boost_weight
        )
