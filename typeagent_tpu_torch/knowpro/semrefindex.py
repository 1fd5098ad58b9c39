"""Semantic-ref index population: knowledge -> SemanticRefs + (term, ordinal).

The port of ``typeagent_tpu/knowpro/semrefindex.py`` (plain Python, the same code).

Backend-independent flattening logic (parity: reference
storage/memory/semrefindex.py:125-652). A KnowledgeResponse contributes:
  * per entity: the entity name, each type, each facet name/value
  * per action (+ inverse): verbs joined by spaces, S/V/O/IO names (when not
    'none'), params, subject-entity facet
  * per topic: the topic text
Each knowledge item becomes one SemanticRef anchored at its chunk.
"""

from __future__ import annotations

from collections.abc import AsyncIterable, Callable

from . import kplib
from .interfaces import (
    IConversation,
    IKnowledgeExtractor,
    IMessage,
    ISemanticRefCollection,
    ITermToSemanticRefIndex,
    Knowledge,
    KnowledgeType,
    MessageOrdinal,
    SemanticRef,
    SemanticRefOrdinal,
    TextLocation,
    Topic,
)
from .messageutils import text_range_from_message_chunk

type KnowledgeValidator = Callable[[KnowledgeType, Knowledge], bool]


def validate_entity(entity: kplib.ConcreteEntity) -> bool:
    return bool(entity.name)


# ---------------------------------------------------------------------------
# Term collectors (no storage access)
# ---------------------------------------------------------------------------


def collect_facet_terms(facet: kplib.Facet | None) -> list[str]:
    if facet is None:
        return []
    terms = [facet.name]
    if facet.value is not None:
        terms.append(str(facet.value))
    return terms


def collect_entity_terms(entity: kplib.ConcreteEntity) -> list[str]:
    terms = [entity.name, *entity.type]
    if entity.facets:
        for facet in entity.facets:
            terms.extend(collect_facet_terms(facet))
    return terms


def collect_action_terms(action: kplib.Action) -> list[str]:
    terms = [" ".join(action.verbs)]
    if action.subject_entity_name != "none":
        terms.append(action.subject_entity_name)
    if action.object_entity_name != "none":
        terms.append(action.object_entity_name)
    if action.indirect_object_entity_name != "none":
        terms.append(action.indirect_object_entity_name)
    if action.params:
        for param in action.params:
            if isinstance(param, str):
                terms.append(param)
            else:
                terms.append(param.name)
                if isinstance(param.value, str):
                    terms.append(param.value)
    terms.extend(collect_facet_terms(action.subject_entity_facet))
    return terms


def collect_knowledge_refs_and_terms(
    base_ordinal: SemanticRefOrdinal,
    message_ordinal: MessageOrdinal,
    chunk_ordinal: int,
    knowledge: kplib.KnowledgeResponse,
) -> tuple[list[SemanticRef], list[tuple[str, SemanticRefOrdinal]]]:
    """Flatten one chunk's KnowledgeResponse into refs + index terms."""
    refs: list[SemanticRef] = []
    terms: list[tuple[str, SemanticRefOrdinal]] = []
    ordinal = base_ordinal
    text_range = text_range_from_message_chunk(message_ordinal, chunk_ordinal)

    for entity in knowledge.entities:
        if not validate_entity(entity):
            continue
        refs.append(SemanticRef(ordinal, text_range, entity))
        for term in collect_entity_terms(entity):
            terms.append((term, ordinal))
        ordinal += 1

    for action in list(knowledge.actions) + list(knowledge.inverse_actions):
        refs.append(SemanticRef(ordinal, text_range, action))
        for term in collect_action_terms(action):
            terms.append((term, ordinal))
        ordinal += 1

    for topic_text in knowledge.topics:
        refs.append(SemanticRef(ordinal, text_range, Topic(text=topic_text)))
        terms.append((topic_text, ordinal))
        ordinal += 1

    return refs, terms


# ---------------------------------------------------------------------------
# Storage writers
# ---------------------------------------------------------------------------


def verify_has_semantic_ref_index(conversation: IConversation) -> None:
    if conversation.secondary_indexes is None or conversation.semantic_refs is None:
        raise ValueError("Conversation does not have an index")


async def add_knowledge_to_semantic_ref_index(
    conversation: IConversation,
    message_ordinal: MessageOrdinal,
    chunk_ordinal: int,
    knowledge: kplib.KnowledgeResponse,
) -> None:
    await add_knowledge_batch_to_semantic_ref_index(
        conversation, [(message_ordinal, chunk_ordinal, knowledge)]
    )


async def add_knowledge_batch_to_semantic_ref_index(
    conversation: IConversation,
    items: list[tuple[MessageOrdinal, int, kplib.KnowledgeResponse]],
) -> None:
    """Bulk-add knowledge from multiple chunks in two storage round-trips."""
    if not items:
        return
    verify_has_semantic_ref_index(conversation)
    semantic_refs = conversation.semantic_refs
    semantic_ref_index = conversation.semantic_ref_index
    assert semantic_refs is not None and semantic_ref_index is not None

    all_refs: list[SemanticRef] = []
    all_terms: list[tuple[str, SemanticRefOrdinal]] = []
    base_ordinal = await semantic_refs.size()
    for msg_ord, chunk_ord, knowledge in items:
        refs, terms = collect_knowledge_refs_and_terms(
            base_ordinal + len(all_refs), msg_ord, chunk_ord, knowledge
        )
        all_refs.extend(refs)
        all_terms.extend(terms)

    if all_refs:
        await semantic_refs.extend(all_refs)
    if all_terms:
        await semantic_ref_index.add_terms_batch(all_terms)


async def add_metadata_to_index_from_list[TMessage: IMessage](
    messages: list[TMessage],
    semantic_refs: ISemanticRefCollection,
    semantic_ref_index: ITermToSemanticRefIndex,
    start_from_ordinal: MessageOrdinal,
    knowledge_validator: KnowledgeValidator | None = None,
) -> None:
    """Index each message's self-reported (LLM-free) metadata knowledge."""
    next_ordinal = await semantic_refs.size()
    collected_refs: list[SemanticRef] = []
    collected_terms: list[tuple[str, SemanticRefOrdinal]] = []

    def _accept(ktype: KnowledgeType, knowledge: Knowledge) -> bool:
        return knowledge_validator is None or knowledge_validator(ktype, knowledge)

    for i, msg in enumerate(messages, start_from_ordinal):
        response = msg.get_knowledge()
        text_range = text_range_from_message_chunk(i)
        for entity in response.entities:
            if _accept("entity", entity):
                collected_refs.append(SemanticRef(next_ordinal, text_range, entity))
                for term in collect_entity_terms(entity):
                    collected_terms.append((term, next_ordinal))
                next_ordinal += 1
        for action in list(response.actions) + list(response.inverse_actions):
            if _accept("action", action):
                collected_refs.append(SemanticRef(next_ordinal, text_range, action))
                for term in collect_action_terms(action):
                    collected_terms.append((term, next_ordinal))
                next_ordinal += 1
        for topic_text in response.topics:
            topic = Topic(text=topic_text)
            if _accept("topic", topic):
                collected_refs.append(SemanticRef(next_ordinal, text_range, topic))
                collected_terms.append((topic.text, next_ordinal))
                next_ordinal += 1

    if collected_refs:
        await semantic_refs.extend(collected_refs)
    if collected_terms:
        await semantic_ref_index.add_terms_batch(collected_terms)


async def add_metadata_to_index[TMessage: IMessage](
    messages: AsyncIterable[TMessage],
    semantic_refs: ISemanticRefCollection,
    semantic_ref_index: ITermToSemanticRefIndex,
    knowledge_validator: KnowledgeValidator | None = None,
) -> None:
    """Full-scan metadata indexing, resuming after the last indexed message."""
    start_from_ordinal = 0
    existing = await semantic_refs.size()
    if existing > 0:
        last_ref = await semantic_refs.get_item(existing - 1)
        if last_ref.range and last_ref.range.start:
            start_from_ordinal = last_ref.range.start.message_ordinal + 1

    batch: list = []
    i = 0
    async for msg in messages:
        if i >= start_from_ordinal:
            batch.append(msg)
        i += 1
    if batch:
        await add_metadata_to_index_from_list(
            batch, semantic_refs, semantic_ref_index, start_from_ordinal,
            knowledge_validator,
        )


async def add_batch_to_semantic_ref_index_from_list[TMessage: IMessage](
    conversation: IConversation,
    messages: list[TMessage],
    batch: list[TextLocation],
    knowledge_extractor: IKnowledgeExtractor,
    concurrency: int = 4,
) -> None:
    """LLM-extract knowledge for the given chunk locations and bulk-add."""
    if not batch:
        return
    from ..models.result import Failure
    from .knowledge import extract_knowledge_from_text_batch

    start_ordinal = batch[0].message_ordinal
    text_batch = []
    for tl in batch:
        list_index = tl.message_ordinal - start_ordinal
        if list_index < 0 or list_index >= len(messages):
            raise IndexError(
                f"Message ordinal {tl.message_ordinal} out of range for list "
                f"starting at {start_ordinal}"
            )
        text_batch.append(messages[list_index].text_chunks[tl.chunk_ordinal].strip())

    results = await extract_knowledge_from_text_batch(
        knowledge_extractor, text_batch, concurrency
    )
    bulk_items: list[tuple[int, int, kplib.KnowledgeResponse]] = []
    for tl, result in zip(batch, results):
        if isinstance(result, Failure):
            raise RuntimeError(f"Knowledge extraction failed: {result.message:.150}")
        bulk_items.append((tl.message_ordinal, tl.chunk_ordinal, result.value))
    if bulk_items:
        await add_knowledge_batch_to_semantic_ref_index(conversation, bulk_items)


async def add_batch_to_semantic_ref_index(
    conversation: IConversation,
    batch: list[TextLocation],
    knowledge_extractor: IKnowledgeExtractor,
    concurrency: int = 4,
) -> None:
    """Like the _from_list variant but pulls chunk text from storage."""
    if not batch:
        return
    from ..models.result import Failure
    from .knowledge import extract_knowledge_from_text_batch

    messages = conversation.messages
    text_batch = [
        (await messages.get_item(tl.message_ordinal))
        .text_chunks[tl.chunk_ordinal]
        .strip()
        for tl in batch
    ]
    results = await extract_knowledge_from_text_batch(
        knowledge_extractor, text_batch, concurrency
    )
    bulk_items: list[tuple[int, int, kplib.KnowledgeResponse]] = []
    for tl, result in zip(batch, results):
        if isinstance(result, Failure):
            raise RuntimeError(f"Knowledge extraction failed: {result.message}")
        bulk_items.append((tl.message_ordinal, tl.chunk_ordinal, result.value))
    if bulk_items:
        await add_knowledge_batch_to_semantic_ref_index(conversation, bulk_items)
