"""Helpers to build search/property term groups programmatically.

(Parity: reference knowpro/searchlib.py — exact_match semantics:
related_terms=[] blocks fuzzy expansion; ';'-embedded related terms;
','-separated multi-values. Public function names and the multiple-choice
prompt text are API/prompt contract; everything else is free to differ.)

The port of ``typeagent_tpu/knowpro/searchlib.py`` (plain Python, the same code).
"""

from __future__ import annotations

from typing import cast

from .interfaces import (
    ISemanticRefCollection,
    KnowledgePropertyName,
    PropertySearchTerm,
    ScoredSemanticRefOrdinal,
    SearchTerm,
    SearchTermGroup,
    SearchTermGroupTypes,
    SemanticRef,
    Term,
)
from .propindex import PropertyNames

_WELL_KNOWN_PROPERTY_NAMES = frozenset(
    {"name", "type", "verb", "subject", "object", "indirectObject", "tag", "topic"}
)


def _pieces(raw: str, sep: str) -> list[str]:
    """Split on ``sep``, trim, drop empties."""
    return [p for p in (piece.strip() for piece in raw.split(sep)) if p]


def _group(op: str, terms) -> SearchTermGroup:
    return SearchTermGroup(boolean_op=op, terms=list(terms))


def create_search_term(
    text: str,
    weight: float | None = None,
    exact_match_value: bool = False,
) -> SearchTerm:
    """related_terms=[] (exact) means 'do not expand'; None means 'resolver may'."""
    related = [] if exact_match_value else None
    return SearchTerm(term=Term(text=text, weight=weight), related_terms=related)


def create_property_search_term(
    name: str,
    value: str,
    exact_match_value: bool = False,
) -> PropertySearchTerm:
    key: KnowledgePropertyName | SearchTerm
    if name in _WELL_KNOWN_PROPERTY_NAMES:
        key = cast(KnowledgePropertyName, name)
    else:
        key = create_search_term(name)
    return PropertySearchTerm(
        property_name=key,
        property_value=create_search_term(value, exact_match_value=exact_match_value),
    )


def create_and_term_group(*terms: SearchTermGroupTypes) -> SearchTermGroup:
    return _group("and", terms)


def create_or_term_group(*terms: SearchTermGroupTypes) -> SearchTermGroup:
    return _group("or", terms)


def create_or_max_term_group(*terms: SearchTermGroupTypes) -> SearchTermGroup:
    return _group("or_max", terms)


def _parse_search_term(text: str) -> SearchTerm | None:
    """'novel;book;bestseller' -> main 'novel' with two related terms."""
    variants = [v.lower() for v in _pieces(text, ";")]
    if not variants:
        return None
    main, *rest = variants
    parsed = SearchTerm(term=Term(text=main))
    if rest:
        parsed.related_terms = [Term(text=v) for v in rest]
    return parsed


def create_search_terms(terms: list[str]) -> list[SearchTerm]:
    """';'-embedded related terms per entry; blank entries drop."""
    parsed = (_parse_search_term(t) for t in terms)
    return [p for p in parsed if p]


def create_property_search_terms(
    property_name_values: dict[str, str],
) -> list[PropertySearchTerm]:
    """Multi-values per name are ','-separated."""
    return [
        create_property_search_term(name, one_value)
        for name, joined in property_name_values.items()
        for one_value in _pieces(joined, ",")
    ]


def create_topic_search_term_group(
    topic_terms: str | list[str],
    exact_match: bool = False,
) -> SearchTermGroup:
    if isinstance(topic_terms, str):
        topic_terms = [topic_terms]
    return _group(
        "or_max",
        (
            create_property_search_term(PropertyNames.Topic.value, t, exact_match)
            for t in topic_terms
        ),
    )


def create_entity_search_term_group(
    name: str | None = None,
    type_: str | None = None,
    facet_name: str | None = None,
    facet_value: str | None = None,
    exact_match: bool = False,
) -> SearchTermGroup:
    slots = {
        PropertyNames.EntityName: name,
        PropertyNames.EntityType: type_,
        PropertyNames.FacetName: facet_name,
        PropertyNames.FacetValue: facet_value,
    }
    return _group(
        "or_max",
        (
            create_property_search_term(prop.value, value, exact_match)
            for prop, value in slots.items()
            if value
        ),
    )


def create_tag_search_term_group(
    tags: list[str],
    exact_match: bool = True,
) -> SearchTermGroup:
    return _group(
        "or_max",
        (
            create_property_search_term(PropertyNames.Tag.value, tag, exact_match)
            for tag in tags
        ),
    )


def create_multiple_choice_question(
    question: str,
    choices: list[str],
    add_none: bool = True,
) -> str:
    # The exact wording below is prompt contract — the answer model keys on it.
    if not choices:
        return question
    lines = [
        f"Multiple choice question:\n{question}\n"
        "Answer using *one or more* of the following choices *only*:\n"
    ]
    lines.extend(f"- {choice.strip()}\n" for choice in choices)
    if add_none:
        lines.append("- None of the above\n")
    return "".join(lines)


async def get_semantic_refs_from_scored_ordinals(
    semantic_refs: ISemanticRefCollection,
    scored_ordinals: list[ScoredSemanticRefOrdinal],
) -> list[SemanticRef]:
    wanted = [scored.semantic_ref_ordinal for scored in scored_ordinals]
    return await semantic_refs.get_multiple(wanted)
