"""Stage 1+2 of the query path: NL -> SearchQuery -> SearchQueryExpr list.

(Parity: reference knowpro/searchlang.py. Compile rules preserved:
  * entity terms -> per-entity or_max groups of property terms + topic terms;
  * action terms -> S.V.O. property-term groups; scope from actions only when
    actor entities are present and the action is not informational;
  * noise-term filter ('thing', 'object', 'concept', 'idea', 'entity');
  * dedupe via PropertyTermSet while compiling entity terms;
  * fallback query with verbs removed from scope for recall
    (`searchlang.py:165-192`);
  * datetime handling: half-open ranges, bare stop dates roll to next
    midnight (`searchlang.py:669-706`).)

The port of ``typeagent_tpu/knowpro/searchlang.py`` (plain Python, the same
code). The verb-scope fallback query is part of the reference's semantics
and runs here as there; it is not a fallback between devices. Stages 1
and 2 each record a span (``translate``, ``compile``) under the caller's,
so that a query's time can be split by stage.
"""

from __future__ import annotations

import copy
import datetime
from collections.abc import Callable
from dataclasses import dataclass, replace
from typing import Literal, TypeGuard, cast

from ..models.result import Result, Success
from ..models.structured import IChatModel, PromptSection, TypedTranslator
from ..utils.trace import span
from .collections import PropertyTermSet
from .convutils import get_time_range_prompt_section_for_conversation
from .date_time_schema import DateTime, DateTimeRange
from .interfaces import (
    DateRange,
    Datetime,
    IConversation,
    KnowledgeType,
    SearchSelectExpr,
    SearchTerm,
    SearchTermGroup,
    SearchTermGroupTypes,
    Term,
    WhenFilter,
)
from .propindex import PropertyNames
from .search import (
    ConversationSearchResult,
    SearchOptions,
    SearchQueryExpr,
    has_conversation_results,
    run_search_query,
)
from .search_query_schema import (
    ActionTerm,
    EntityTerm,
    SearchExpr,
    SearchFilter,
    SearchQuery,
    VerbsTerm,
)
from .searchlib import create_property_search_term

type SearchQueryTranslator = TypedTranslator[SearchQuery]

# Generic words the LLM produces that match everything and mean nothing.
_NOISE_TERMS = frozenset({"thing", "object", "concept", "idea", "entity"})


# ---------------------------------------------------------------------------
# Small helpers (shared by the compiler below)
# ---------------------------------------------------------------------------


def is_entity_term_list(
    terms: list[EntityTerm] | Literal["*"] | None,
) -> TypeGuard[list[EntityTerm]]:
    return isinstance(terms, list)


def optimize_or_max(term_group: SearchTermGroup) -> SearchTermGroupTypes:
    """A one-term or_max group is just that term."""
    return term_group.terms[0] if len(term_group.terms) == 1 else term_group


def datetime_from_date_time(date_time: DateTime) -> Datetime:
    # A missing time means midnight — the START of a range. LLM times are
    # assumed UTC.
    t = date_time.time
    return Datetime(
        year=date_time.date.year,
        month=date_time.date.month,
        day=date_time.date.day,
        hour=t.hour if t else 0,
        minute=t.minute if t else 0,
        second=t.seconds if t else 0,
        tzinfo=datetime.timezone.utc,
    )


def exclusive_stop_from_date_time(date_time: DateTime) -> Datetime:
    """A bare stop date names a whole day -> roll to the next midnight so the
    half-open range includes it."""
    stop = datetime_from_date_time(date_time)
    return stop if date_time.time is not None else stop + datetime.timedelta(days=1)


def date_range_from_datetime_range(date_time_range: DateTimeRange) -> DateRange:
    stop = date_time_range.stop_date
    return DateRange(
        start=datetime_from_date_time(date_time_range.start_date),
        end=exclusive_stop_from_date_time(stop) if stop else None,
    )


# ---------------------------------------------------------------------------
# Options / results
# ---------------------------------------------------------------------------


@dataclass
class LanguageSearchFilter:
    knowledgeType: KnowledgeType | None = None
    threadDescription: str | None = None
    tags: list[str] | None = None


@dataclass
class LanguageQueryCompileOptions:
    exact_scope: bool = False  # fuzzy matching when applying scope?
    verb_scope: bool = True
    term_filter: Callable[[str], bool] | None = None  # rejects noise terms
    apply_scope: bool = True  # debug: disable scope matching entirely


@dataclass
class LanguageQueryExpr:
    query_text: str
    query: SearchQuery
    query_expressions: list[SearchQueryExpr]


@dataclass
class LanguageSearchOptions(SearchOptions):
    compile_options: LanguageQueryCompileOptions | None = None
    fallback_rag_options: None = None
    model_instructions: list[PromptSection] | None = None

    def __repr__(self) -> str:
        set_fields = (
            (name, value)
            for name, value in vars(self).items()
            if value is not None and not name.startswith("_")
        )
        inner = ", ".join(f"{name}={value!r}" for name, value in set_fields)
        return f"{type(self).__name__}({inner})"


@dataclass
class LanguageSearchDebugContext:
    search_query: SearchQuery | None = None
    search_query_expr: list[SearchQueryExpr] | None = None
    use_search_query: SearchQuery | None = None
    use_compiled_search_query_exprs: list[SearchQueryExpr] | None = None
    # Stage-3 output, captured for batch recorders and differential tests.
    search_results: "list[ConversationSearchResult] | None" = None


# ---------------------------------------------------------------------------
# Stage 2: SearchQuery -> SearchQueryExpr
# ---------------------------------------------------------------------------


class SearchQueryCompiler:
    def __init__(
        self,
        conversation: IConversation,
        options: LanguageQueryCompileOptions | None = None,
        lang_search_filter: LanguageSearchFilter | None = None,
    ):
        self.conversation = conversation
        self.options = options = options or LanguageQueryCompileOptions()
        self.lang_search_filter = lang_search_filter or LanguageSearchFilter()
        self.exact_scope = options.exact_scope
        self.verb_scope = options.verb_scope
        self.term_filter = options.term_filter
        self.apply_scope = options.apply_scope
        self.entity_terms_added = PropertyTermSet()
        self.dedupe = True

    # -- string guards + term-append primitives --------------------------------

    def is_searchable_string(self, value: str) -> bool:
        if not value or value == "*":
            return False
        return self.term_filter is None or self.term_filter(value)

    def is_noise_term(self, value: str) -> bool:
        return value.lower() in _NOISE_TERMS

    def add_search_term_to_group(
        self, term: str, term_group: SearchTermGroup
    ) -> None:
        if self.is_searchable_string(term):
            term_group.terms.append(SearchTerm(Term(term)))

    def add_property_term_to_group(
        self,
        property_name: str,
        property_value: str,
        term_group: SearchTermGroup,
        exact_match_value: bool = False,
    ) -> None:
        if not (
            self.is_searchable_string(property_name)
            and self.is_searchable_string(property_value)
        ):
            return
        if self.is_noise_term(property_value):
            return
        if self.dedupe and self.entity_terms_added.has(property_name, property_value):
            return
        search_term = create_property_search_term(
            property_name, property_value, exact_match_value
        )
        term_group.terms.append(search_term)
        self.entity_terms_added.add(property_name, search_term.property_value.term)

    def add_entity_name_to_group(
        self,
        entity_term: EntityTerm,
        property_name: PropertyNames,
        term_group: SearchTermGroup,
        exact_match_value: bool = False,
    ) -> None:
        if not entity_term.is_name_pronoun:
            self.add_property_term_to_group(
                property_name.value, entity_term.name, term_group, exact_match_value
            )

    def add_entity_names_to_group(
        self,
        entity_terms: list[EntityTerm],
        property_name: PropertyNames,
        term_group: SearchTermGroup,
        exact_match_value: bool = False,
    ) -> None:
        for entity_term in entity_terms:
            self.add_entity_name_to_group(
                entity_term, property_name, term_group, exact_match_value
            )

    def add_verbs_to_group(
        self, verbs: VerbsTerm, term_group: SearchTermGroup
    ) -> None:
        for verb in verbs.words:
            self.add_property_term_to_group("verb", verb, term_group)

    def add_entity_term_to_group(
        self,
        entity_term: EntityTerm,
        term_group: SearchTermGroup,
        exact_match_name: bool = False,
    ) -> None:
        """Entity -> name/type property terms + one term per facet shape."""
        self.add_property_term_to_group(
            PropertyNames.EntityName.value,
            entity_term.name,
            term_group,
            exact_match_name,
        )
        for type_name in entity_term.type or ():
            self.add_property_term_to_group(
                PropertyNames.EntityType.value, type_name, term_group
            )
        for facet in entity_term.facets or ():
            # Wildcards select which half of the facet is being searched.
            wild_name = facet.facet_name == "*"
            wild_value = facet.facet_value == "*"
            if wild_name and wild_value:
                continue
            if wild_name:
                self.add_property_term_to_group(
                    PropertyNames.FacetValue.value, facet.facet_value, term_group
                )
            elif wild_value:
                self.add_property_term_to_group(
                    PropertyNames.FacetName.value, facet.facet_name, term_group
                )
            else:
                self.add_property_term_to_group(
                    facet.facet_name, facet.facet_value, term_group
                )

    def add_entity_term_as_search_terms_to_group(
        self, entity_term: EntityTerm, term_group: SearchTermGroup
    ) -> None:
        if entity_term.is_name_pronoun:
            return
        self.add_search_term_to_group(entity_term.name, term_group)
        for type_name in entity_term.type or ():
            self.add_search_term_to_group(type_name, term_group)
        for facet in entity_term.facets or ():
            self.add_search_term_to_group(facet.facet_name, term_group)
            self.add_search_term_to_group(facet.facet_value, term_group)

    # -- filter compilation ------------------------------------------------------

    def compile_query(self, query: SearchQuery) -> list[SearchQueryExpr]:
        query = copy.copy(query)
        return [self.compile_search_expr(expr) for expr in query.search_expressions]

    def compile_search_expr(self, search_expr: SearchExpr) -> SearchQueryExpr:
        selects = [
            self.compile_search_filter(f) for f in (search_expr.filters or ())
        ]
        return SearchQueryExpr(
            select_expressions=selects, raw_query=search_expr.rewritten_query
        )

    def compile_search_filter(self, filter: SearchFilter) -> SearchSelectExpr:
        return SearchSelectExpr(
            self.compile_term_group(filter), self.compile_when(filter)
        )

    def compile_term_group(self, filter: SearchFilter) -> SearchTermGroup:
        term_group = SearchTermGroup(boolean_op="or", terms=[])
        self.entity_terms_added.clear()
        entity_terms = filter.entity_search_terms
        if is_entity_term_list(entity_terms):
            self.compile_entity_terms(entity_terms, term_group)
        if filter.action_search_term:
            self.compile_action_term_as_search_terms(
                filter.action_search_term, term_group, False
            )
        if filter.search_terms is not None:
            self.compile_search_terms(filter.search_terms, term_group)
        elif len(term_group.terms) == 0:
            # Summary request: match every topic. (NB: an explicitly EMPTY
            # searchTerms list is NOT a summary — only an absent field is.)
            term_group.terms.append(create_property_search_term("topic", "*"))
        return term_group

    def compile_when(self, filter: SearchFilter) -> WhenFilter | None:
        when: WhenFilter | None = None
        action_term = filter.action_search_term
        if (
            self.apply_scope
            and action_term is not None
            and self.should_add_scope(action_term)
        ):
            include_verbs = True if self.verb_scope is None else self.verb_scope
            scope_terms = self.compile_scope(
                action_term,
                include_additional_entities=False,
                include_verbs=include_verbs,
            )
            if scope_terms.terms:
                when = when or WhenFilter()
                when.scope_defining_terms = scope_terms
        if filter.time_range is not None:
            when = when or WhenFilter()
            when.date_range = date_range_from_datetime_range(filter.time_range)
        return when

    def should_add_scope(self, action_term: ActionTerm) -> bool:
        if not action_term or action_term.is_informational:
            return False
        # With exact scope, always; otherwise only when there is a subject.
        return self.exact_scope or is_entity_term_list(action_term.actor_entities)

    # -- entity / search-term compilation ------------------------------------------

    def compile_search_terms(
        self, search_terms: list[str], term_group: SearchTermGroup | None = None
    ) -> SearchTermGroup:
        if term_group is None:
            term_group = SearchTermGroup(boolean_op="or", terms=[])
        term_group.terms.extend(SearchTerm(Term(t)) for t in search_terms)
        return term_group

    def compile_entity_terms(
        self,
        entity_terms: list[EntityTerm],
        term_group: SearchTermGroup,
        use_or_max: bool = True,
    ) -> None:
        if use_or_max:
            save_dedupe, self.dedupe = self.dedupe, False
            for term in entity_terms:
                or_max = SearchTermGroup(boolean_op="or_max", terms=[])
                self.add_entity_term_to_group(term, or_max)
                term_group.terms.append(optimize_or_max(or_max))
            self.dedupe = save_dedupe
        else:
            for term in entity_terms:
                self.add_entity_term_to_group(term, term_group)
        # Entities (and their concrete facet values) also match as topics.
        for term in entity_terms:
            self.add_entity_name_to_group(term, PropertyNames.Topic, term_group)
            for facet in term.facets or ():
                if facet.facet_value not in (None, "*"):
                    self.add_property_term_to_group(
                        PropertyNames.Topic.value, facet.facet_value, term_group
                    )

    def compile_entity_terms_as_search_terms(
        self,
        entity_terms: list[EntityTerm],
        term_group: SearchTermGroup,
    ) -> None:
        for term in entity_terms:
            self.add_entity_term_as_search_terms_to_group(term, term_group)

    # -- action compilation ----------------------------------------------------------

    def compile_action_term_as_search_terms(
        self,
        action_term: ActionTerm,
        term_group: SearchTermGroup | None = None,
        use_or_max: bool = True,
    ) -> SearchTermGroup:
        if term_group is None:
            term_group = SearchTermGroup("or")
        action_group = SearchTermGroup("or_max") if use_or_max else term_group
        if action_term.action_verbs is not None:
            for verb in action_term.action_verbs.words:
                self.add_property_term_to_group("topic", verb, action_group)
        for entities in (
            action_term.actor_entities,
            action_term.target_entities,
            action_term.additional_entities,
        ):
            if is_entity_term_list(entities):
                self.compile_entity_terms_as_search_terms(entities, action_group)
        if use_or_max and action_group.terms:
            term_group.terms.append(action_group)
        return term_group

    def compile_scope(
        self,
        action_term: ActionTerm,
        include_additional_entities: bool = True,
        include_verbs: bool = True,
    ) -> SearchTermGroup:
        save_dedupe, self.dedupe = self.dedupe, False
        term_group = self.compile_action_term(action_term, True, include_verbs)
        if include_additional_entities and is_entity_term_list(
            action_term.additional_entities
        ):
            self.add_entity_names_to_group(
                action_term.additional_entities,
                PropertyNames.EntityName,
                term_group,
                self.exact_scope,
            )
        self.dedupe = save_dedupe
        return term_group

    def compile_action_term(
        self,
        action_term: ActionTerm,
        use_and: bool,
        include_verbs: bool,
    ) -> SearchTermGroup:
        save_dedupe, self.dedupe = self.dedupe, False
        try:
            if not is_entity_term_list(action_term.target_entities):
                return self.compile_subject_and_verb(action_term)
            term_group = SearchTermGroup("and" if use_and else "or")
            for entity in action_term.target_entities:
                # S.V.O. == Subject, Verb, Object
                svo = (
                    self.compile_subject_and_verb(action_term)
                    if include_verbs
                    else self.compile_subject(action_term)
                )
                # A target can be an action object OR an entity name.
                object_group = self.compile_object(entity)
                if object_group.terms:
                    svo.terms.append(object_group)
                term_group.terms.append(svo)
            if len(term_group.terms) == 1:
                return cast(SearchTermGroup, term_group.terms[0])
            return term_group
        finally:
            self.dedupe = save_dedupe

    def compile_subject_and_verb(self, action_term: ActionTerm) -> SearchTermGroup:
        term_group = self.compile_subject(action_term)
        if action_term.action_verbs is not None:
            self.add_verbs_to_group(action_term.action_verbs, term_group)
        return term_group

    def compile_subject(self, action_term: ActionTerm) -> SearchTermGroup:
        term_group = SearchTermGroup("and")
        if is_entity_term_list(action_term.actor_entities):
            self.add_entity_names_to_group(
                action_term.actor_entities, PropertyNames.Subject, term_group
            )
        return term_group

    # Retained for API parity with the reference compiler.
    def add_subject_to_group(
        self, action_term: ActionTerm, term_group: SearchTermGroup
    ) -> None:
        if is_entity_term_list(action_term.actor_entities):
            self.add_entity_names_to_group(
                action_term.actor_entities, PropertyNames.Subject, term_group
            )

    def compile_object(self, entity: EntityTerm) -> SearchTermGroup:
        term_group = SearchTermGroup("or")
        self.add_entity_name_to_group(entity, PropertyNames.Object, term_group)
        for prop in (PropertyNames.EntityName, PropertyNames.Topic):
            self.add_entity_name_to_group(entity, prop, term_group, self.exact_scope)
        return term_group


# ---------------------------------------------------------------------------
# Module-level entry points (stages 1-3 orchestration)
# ---------------------------------------------------------------------------


def create_search_query_translator(model: IChatModel) -> SearchQueryTranslator:
    """Build the NL->SearchQuery translator over a chat model."""
    return TypedTranslator(
        model,
        SearchQuery,
        type_name="SearchQuery",
        instructions=(
            "You are a service that translates natural-language questions "
            'about a conversation into JSON objects of type "SearchQuery".'
        ),
    )


def compile_search_query(
    conversation: IConversation,
    query: SearchQuery,
    options: LanguageQueryCompileOptions | None = None,
    lang_search_filter: LanguageSearchFilter | None = None,
) -> list[SearchQueryExpr]:
    compiler = SearchQueryCompiler(
        conversation, options or LanguageQueryCompileOptions(), lang_search_filter
    )
    return compiler.compile_query(query)


def compile_search_filter(
    conversation: IConversation,
    search_filter: SearchFilter,
    options: LanguageQueryCompileOptions | None = None,
    lang_search_filter: LanguageSearchFilter | None = None,
) -> SearchSelectExpr:
    compiler = SearchQueryCompiler(
        conversation, options or LanguageQueryCompileOptions(), lang_search_filter
    )
    return compiler.compile_search_filter(search_filter)


def _compile_fallback_query(
    conversation: IConversation,
    query: SearchQuery,
    compile_options: LanguageQueryCompileOptions,
    lang_search_filter: LanguageSearchFilter | None = None,
) -> list[SearchQueryExpr] | None:
    """LLM verb choices may miss the indexed action verbs; a verbless-scope
    variant keeps subject/object scoping while improving recall."""
    if not compile_options.verb_scope or compile_options.exact_scope:
        return None
    return compile_search_query(
        conversation,
        query,
        replace(compile_options, verb_scope=False),
        lang_search_filter,
    )


async def search_query_from_language(
    conversation: IConversation,
    translator: SearchQueryTranslator,
    query_text: str,
    model_instructions: list[PromptSection] | None = None,
) -> Result[SearchQuery]:
    prompt_preamble: list[PromptSection] = list(model_instructions or ())
    time_range = await get_time_range_prompt_section_for_conversation(conversation)
    if time_range:
        prompt_preamble.append(time_range)
    return await translator.translate(query_text, prompt_preamble=prompt_preamble)


async def search_query_expr_from_language(
    conversation: IConversation,
    translator: SearchQueryTranslator,
    query_text: str,
    options: LanguageSearchOptions | None = None,
    lang_search_filter: LanguageSearchFilter | None = None,
    debug_context: LanguageSearchDebugContext | None = None,
) -> Result[LanguageQueryExpr]:
    options = options or LanguageSearchOptions()
    query = debug_context.use_search_query if debug_context else None
    if query is None:
        with span("translate"):
            query_result = await search_query_from_language(
                conversation, translator, query_text, options.model_instructions
            )
        if not isinstance(query_result, Success):
            return query_result
        query = query_result.value
    if debug_context:
        debug_context.search_query = query
    with span("compile"):
        query_expressions = compile_search_query(
            conversation, query, options.compile_options, lang_search_filter
        )
    return Success(LanguageQueryExpr(query_text, query, query_expressions))


async def search_conversation_with_language(
    conversation: IConversation,
    query_translator: SearchQueryTranslator,
    search_text: str,
    options: LanguageSearchOptions | None = None,
    lang_search_filter: LanguageSearchFilter | None = None,
    debug_context: LanguageSearchDebugContext | None = None,
) -> Result[list[ConversationSearchResult]]:
    """Stages 1-3: translate, compile, execute (with verb-scope fallback)."""
    options = options or LanguageSearchOptions()
    if debug_context and debug_context.use_compiled_search_query_exprs:
        search_query = debug_context.use_search_query
        search_query_exprs = debug_context.use_compiled_search_query_exprs
    else:
        lang_query_result = await search_query_expr_from_language(
            conversation,
            query_translator,
            search_text,
            options,
            lang_search_filter,
            debug_context,
        )
        if not isinstance(lang_query_result, Success):
            return lang_query_result
        search_query = lang_query_result.value.query
        search_query_exprs = lang_query_result.value.query_expressions

    if debug_context:
        debug_context.search_query_expr = search_query_exprs

    fallback_query_exprs: list[SearchQueryExpr] | None = None
    if search_query:
        fallback_query_exprs = _compile_fallback_query(
            conversation,
            search_query,
            options.compile_options or LanguageQueryCompileOptions(),
            lang_search_filter,
        )

    search_results: list[ConversationSearchResult] = []
    for i, search_query_expr in enumerate(search_query_exprs):
        query_result = await run_search_query(conversation, search_query_expr, options)
        if fallback_query_exprs and not has_conversation_results(query_result):
            # Re-run with verb matching off in scopes (better recall).
            query_result = await run_search_query(
                conversation, fallback_query_exprs[i], options
            )
        search_results.extend(query_result)

    if debug_context:
        debug_context.search_results = search_results
    return Success(search_results)
