"""Property-index population logic, shared by both storage backends.

The port of ``typeagent_tpu/knowpro/propindex.py`` (plain Python, the same code).

(Parity: reference storage/memory/propindex.py:21-220 — PropertyNames,
"prop.{name}@@{value}" key format, and the entity/action/tag property
collectors.)
"""

from __future__ import annotations

import enum
from typing import assert_never

from . import kplib
from .collections import TextRangesInScope
from .interfaces import (
    IConversation,
    IPropertyToSemanticRefIndex,
    Knowledge,
    ISemanticRefCollection,
    ScoredSemanticRefOrdinal,
    SemanticRefOrdinal,
    Tag,
    Topic,
)


class PropertyNames(enum.Enum):
    EntityName = "name"
    EntityType = "type"
    FacetName = "facet.name"
    FacetValue = "facet.value"
    Verb = "verb"
    Subject = "subject"
    Object = "object"
    IndirectObject = "indirectObject"
    Tag = "tag"
    Topic = "topic"


PROPERTY_DELIMITER = "@@"


def make_property_term_text(name: str, value: str) -> str:
    return f"prop.{name}{PROPERTY_DELIMITER}{value}"


def split_property_term_text(term_text: str) -> tuple[str, str]:
    parts = term_text.split(PROPERTY_DELIMITER, 1)
    return parts[0], parts[1]


def _facet_value_str(value: kplib.Value) -> str:
    # Floats are stored with %g formatting for stable round-tripping.
    if isinstance(value, float) and not isinstance(value, bool):
        return f"{value:g}"
    return str(value)


def collect_facet_properties(
    facet: kplib.Facet | None, ordinal: SemanticRefOrdinal
) -> list[tuple[str, str, SemanticRefOrdinal]]:
    if facet is None:
        return []
    props = [(PropertyNames.FacetName.value, facet.name, ordinal)]
    if facet.value is not None:
        props.append(
            (PropertyNames.FacetValue.value, _facet_value_str(facet.value), ordinal)
        )
    return props


def collect_entity_properties(
    entity: kplib.ConcreteEntity, ordinal: SemanticRefOrdinal
) -> list[tuple[str, str, SemanticRefOrdinal]]:
    props = [(PropertyNames.EntityName.value, entity.name, ordinal)]
    for type_name in entity.type:
        props.append((PropertyNames.EntityType.value, type_name, ordinal))
    if entity.facets:
        for facet in entity.facets:
            props.extend(collect_facet_properties(facet, ordinal))
    return props


def collect_action_properties(
    action: kplib.Action, ordinal: SemanticRefOrdinal
) -> list[tuple[str, str, SemanticRefOrdinal]]:
    props = [(PropertyNames.Verb.value, " ".join(action.verbs), ordinal)]
    if action.subject_entity_name != "none":
        props.append((PropertyNames.Subject.value, action.subject_entity_name, ordinal))
    if action.object_entity_name != "none":
        props.append((PropertyNames.Object.value, action.object_entity_name, ordinal))
    if action.indirect_object_entity_name != "none":
        props.append(
            (
                PropertyNames.IndirectObject.value,
                action.indirect_object_entity_name,
                ordinal,
            )
        )
    return props


def collect_semref_properties(
    knowledge: Knowledge, ordinal: SemanticRefOrdinal
) -> list[tuple[str, str, SemanticRefOrdinal]]:
    """All property tuples one semref contributes to the property index."""
    if isinstance(knowledge, kplib.Action):
        return collect_action_properties(knowledge, ordinal)
    if isinstance(knowledge, kplib.ConcreteEntity):
        return collect_entity_properties(knowledge, ordinal)
    if isinstance(knowledge, Tag):
        return [(PropertyNames.Tag.value, knowledge.text, ordinal)]
    if isinstance(knowledge, Topic):
        return []
    assert_never(knowledge)


async def add_to_property_index(
    conversation: IConversation,
    start_at_ordinal: SemanticRefOrdinal,
) -> None:
    """Populate the property index from semrefs starting at an ordinal."""
    csi = conversation.secondary_indexes
    if not csi or conversation.semantic_refs is None:
        return
    semantic_refs = conversation.semantic_refs
    size = await semantic_refs.size()
    if size == 0:
        return
    property_index = csi.property_to_semantic_ref_index
    if property_index is None:
        from ..storage.memory.indexes import PropertyIndex

        property_index = csi.property_to_semantic_ref_index = PropertyIndex()

    collected: list[tuple[str, str, SemanticRefOrdinal]] = []
    for ordinal, semantic_ref in enumerate(
        await semantic_refs.get_slice(start_at_ordinal, size), start_at_ordinal
    ):
        assert semantic_ref.semantic_ref_ordinal == ordinal
        collected.extend(collect_semref_properties(semantic_ref.knowledge, ordinal))
    if collected:
        await property_index.add_properties_batch(collected)


async def build_property_index(conversation: IConversation) -> None:
    await add_to_property_index(conversation, 0)


async def lookup_property_in_property_index(
    property_index: IPropertyToSemanticRefIndex,
    property_name: str,
    property_value: str,
    semantic_refs: ISemanticRefCollection,
    ranges_in_scope: TextRangesInScope | None = None,
) -> list[ScoredSemanticRefOrdinal] | None:
    scored_refs = await property_index.lookup_property(property_name, property_value)
    if ranges_in_scope is not None and scored_refs:
        metadata = await semantic_refs.get_metadata_multiple(
            [sr.semantic_ref_ordinal for sr in scored_refs]
        )
        scored_refs = [
            sr
            for sr, m in zip(scored_refs, metadata)
            if ranges_in_scope.is_range_in_scope(m.range)
        ]
    return scored_refs or None


async def is_known_property(
    property_index: IPropertyToSemanticRefIndex | None,
    property_name: PropertyNames,
    property_value: str,
) -> bool:
    if property_index is None:
        return False
    refs = await property_index.lookup_property(property_name.value, property_value)
    return bool(refs)
