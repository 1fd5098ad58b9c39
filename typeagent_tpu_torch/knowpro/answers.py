"""Stage 4: answer generation from search results.

(Parity: reference knowpro/answers.py — strict answer-only-from-context
prompt, per-search-result answers with bounded concurrency and optional
fast-stop (env TYPEAGENT_ANSWER_CONCURRENCY / TYPEAGENT_ANSWER_FAST_STOP),
entity/topic merging with source-ordinal enrichment, multi-answer combine.
Prompt rule text is part of the behavioral contract and matches verbatim.)

The port of ``typeagent_tpu/knowpro/answers.py`` (plain Python, the same
code): the ``[ANSWER CONTEXT]`` text it builds is byte for byte the JAX
package's.
"""

from __future__ import annotations

import asyncio
import os
from collections.abc import Iterable
from dataclasses import dataclass, field
from typing import Any

from ..models.result import Failure
from ..models.structured import IChatModel, TypedTranslator
from .answer_context_schema import AnswerContext, RelevantKnowledge, RelevantMessage
from .answer_response_schema import AnswerResponse
from .collections import Scored, get_top_k
from .interfaces import (
    DateRange,
    Datetime,
    IConversation,
    IMessage,
    IMessageCollection,
    IMessageMetadata,
    ISemanticRefCollection,
    ITermToSemanticRefIndex,
    Knowledge,
    KnowledgeType,
    MessageOrdinal,
    ScoredMessageOrdinal,
    ScoredSemanticRefOrdinal,
    SemanticRef,
    SemanticRefSearchResult,
    TextLocation,
    TextRange,
    Topic,
)
from .kplib import ConcreteEntity, Facet
from .search import ConversationSearchResult

CONCURRENCY_ENVVAR = "TYPEAGENT_ANSWER_CONCURRENCY"
FAST_STOP_ENVVAR = "TYPEAGENT_ANSWER_FAST_STOP"


@dataclass
class AnswerContextOptions:
    entities_top_k: int | None = None
    topics_top_k: int | None = None
    messages_top_k: int | None = None
    chunking: bool | None = None
    debug: bool = False


@dataclass
class AnswerGeneratorSettings:
    """Controls how generate_answers() processes search results.

    Defaults preserve sequential run-everything behavior; the env vars opt
    callers into concurrency/fast-stop without code changes.
    """

    concurrency: int = field(
        default_factory=lambda: int(os.getenv(CONCURRENCY_ENVVAR, "1"))
    )
    fast_stop: bool = field(
        default_factory=lambda: os.getenv(FAST_STOP_ENVVAR, "false").lower() == "true"
    )


def create_answer_translator(model: IChatModel) -> TypedTranslator[AnswerResponse]:
    return TypedTranslator(
        model,
        AnswerResponse,
        type_name="AnswerResponse",
        instructions=(
            "You are a service that answers user questions from supplied "
            'context, responding with JSON objects of type "AnswerResponse".'
        ),
    )


# ---------------------------------------------------------------------------
# Knowledge merging (entities/topics collapse by name before prompting)
# ---------------------------------------------------------------------------

type MergedFacets = dict[str, list[str]]


class MergedKnowledge:
    source_message_ordinals: set[MessageOrdinal] | None = None


@dataclass
class MergedTopic(MergedKnowledge):
    topic: Topic


@dataclass
class MergedEntity(MergedKnowledge):
    name: str
    type: list[str]
    facets: MergedFacets | None = None


def merge_message_ordinals(merged: MergedKnowledge, sr: SemanticRef) -> None:
    if merged.source_message_ordinals is None:
        merged.source_message_ordinals = set()
    merged.source_message_ordinals.add(sr.range.start.message_ordinal)


def facets_to_merged_facets(facets: list[Facet]) -> MergedFacets:
    merged: MergedFacets = {}
    for facet in facets:
        merged.setdefault(facet.name.lower(), []).append(str(facet.value).lower())
    return merged


def merged_facets_to_facets(merged_facets: MergedFacets) -> list[Facet]:
    return [
        Facet(name=name, value="; ".join(values))
        for name, values in merged_facets.items()
        if values
    ]


def concrete_to_merged_entity(entity: ConcreteEntity) -> MergedEntity:
    return MergedEntity(
        name=entity.name.lower(),
        type=sorted(tp.lower() for tp in entity.type),
        facets=facets_to_merged_facets(entity.facets) if entity.facets else None,
    )


def merged_to_concrete_entity(merged_entity: MergedEntity) -> ConcreteEntity:
    entity = ConcreteEntity(name=merged_entity.name, type=merged_entity.type)
    if merged_entity.facets:
        entity.facets = merged_facets_to_facets(merged_entity.facets)
    return entity


def merge_scored_topics(
    scored_topics: Iterable[Scored[SemanticRef]],
    merge_ordinals: bool,
) -> dict[str, Scored[MergedTopic]]:
    merged: dict[str, Scored[MergedTopic]] = {}
    for scored in scored_topics:
        topic = scored.item.knowledge
        assert isinstance(topic, Topic)
        slot = merged.get(topic.text)
        if slot is None:
            slot = merged[topic.text] = Scored(MergedTopic(topic=topic), scored.score)
        elif scored.score > slot.score:
            slot.score = scored.score
        if merge_ordinals:
            merge_message_ordinals(slot.item, scored.item)
    return merged


def merge_scored_concrete_entities(
    scored_entities: Iterable[Scored[SemanticRef]],
    merge_ordinals: bool,
) -> dict[str, Scored[MergedEntity]]:
    merged: dict[str, Scored[MergedEntity]] = {}
    for scored in scored_entities:
        assert isinstance(scored.item.knowledge, ConcreteEntity)
        incoming = concrete_to_merged_entity(scored.item.knowledge)
        slot = merged.get(incoming.name)
        if slot is None:
            slot = merged[incoming.name] = Scored(incoming, scored.score)
        else:
            held = slot.item
            if not held.type:
                held.type = incoming.type
            elif incoming.type:
                held.type = sorted(set(held.type) | set(incoming.type))
            if not held.facets:
                held.facets = incoming.facets
            elif incoming.facets:
                for name, values in incoming.facets.items():
                    held.facets.setdefault(name, []).extend(values)
            if scored.score > slot.score:
                slot.score = scored.score
        if merge_ordinals:
            merge_message_ordinals(slot.item, scored.item)
    return merged


# ---------------------------------------------------------------------------
# Source enrichment (time ranges, origin/audience from message metadata)
# ---------------------------------------------------------------------------


def text_range_from_message_range(
    start: MessageOrdinal, end: MessageOrdinal
) -> TextRange | None:
    if start == end:
        return TextRange(start=TextLocation(start))
    if start < end:
        return TextRange(start=TextLocation(start), end=TextLocation(end))
    raise ValueError(f"Expect message ordinal range: {start} <= {end}")


def get_enclosing_text_range(
    message_ordinals: Iterable[MessageOrdinal],
) -> TextRange | None:
    ordinals = list(message_ordinals)
    if not ordinals:
        return None
    return text_range_from_message_range(min(ordinals), max(ordinals))


async def get_enclosing_date_range_for_text_range(
    messages: IMessageCollection,
    range: TextRange,
) -> DateRange | None:
    start_timestamp = (await messages.get_item(range.start.message_ordinal)).timestamp
    if not start_timestamp:
        return None
    end_timestamp: str | None = None
    if range.end and range.end.message_ordinal < await messages.size():
        end_timestamp = (await messages.get_item(range.end.message_ordinal)).timestamp
    return DateRange(
        start=Datetime.fromisoformat(start_timestamp),
        end=Datetime.fromisoformat(end_timestamp) if end_timestamp else None,
    )


async def get_enclosing_data_range_for_messages(
    messages: IMessageCollection,
    message_ordinals: Iterable[MessageOrdinal],
) -> DateRange | None:
    text_range = get_enclosing_text_range(message_ordinals)
    if not text_range:
        return None
    return await get_enclosing_date_range_for_text_range(messages, text_range)


@dataclass
class MessageMetadata(IMessageMetadata):
    source: str | list[str] | None = None
    dest: str | list[str] | None = None


async def get_enclosing_metadata_for_messages(
    messages: IMessageCollection,
    message_ordinals: Iterable[MessageOrdinal],
) -> IMessageMetadata:
    sources: set[str] = set()
    dests: set[str] = set()

    def collect(into: set[str], value: str | list[str] | None) -> None:
        if isinstance(value, str):
            into.add(value)
        elif isinstance(value, list):
            into.update(value)

    for ordinal in message_ordinals:
        metadata = (await messages.get_item(ordinal)).metadata
        if metadata:
            collect(sources, metadata.source)
            collect(dests, metadata.dest)

    # Sorted: set iteration order varies per process (hash randomization),
    # and these lists land in prompts and pinned golden digests.
    return MessageMetadata(
        source=sorted(sources) or None, dest=sorted(dests) or None
    )


async def create_relevant_knowledge(
    conversation: IConversation,
    knowledge: Knowledge,
    source_message_ordinals: set[MessageOrdinal] | None = None,
) -> RelevantKnowledge:
    relevant = RelevantKnowledge(knowledge)
    if source_message_ordinals:
        relevant.time_range = await get_enclosing_data_range_for_messages(
            conversation.messages, source_message_ordinals
        )
        meta = await get_enclosing_metadata_for_messages(
            conversation.messages, source_message_ordinals
        )
        if meta.source:
            relevant.origin = meta.source
        if meta.dest:
            relevant.audience = meta.dest
    return relevant


# ---------------------------------------------------------------------------
# Context assembly
# ---------------------------------------------------------------------------


async def get_scored_semantic_refs_from_ordinals_iter(
    semantic_refs: ISemanticRefCollection,
    semantic_ref_matches: list[ScoredSemanticRefOrdinal],
    knowledge_type: KnowledgeType,
) -> list[Scored[SemanticRef]]:
    if not semantic_ref_matches:
        return []
    metadata = await semantic_refs.get_metadata_multiple(
        [m.semantic_ref_ordinal for m in semantic_ref_matches]
    )
    of_type = [
        (sr_match, m.ordinal)
        for sr_match, m in zip(semantic_ref_matches, metadata)
        if m.knowledge_type == knowledge_type
    ]
    if not of_type:
        return []
    full_refs = await semantic_refs.get_multiple([o for _, o in of_type])
    return [
        Scored(item=ref, score=sr_match.score)
        for (sr_match, _), ref in zip(of_type, full_refs)
    ]


async def get_relevant_messages_for_answer[
    TMessage: IMessage, TIndex: ITermToSemanticRefIndex
](
    conversation: IConversation[TMessage, TIndex],
    message_matches: list[ScoredMessageOrdinal],
    top_k: int | None = None,
) -> list[RelevantMessage]:
    relevant: list[RelevantMessage] = []
    for scored in message_matches:
        msg = await conversation.messages.get_item(scored.message_ordinal)
        if not msg.text_chunks:
            continue
        metadata: IMessageMetadata | None = msg.metadata
        assert metadata is not None
        chunks = msg.text_chunks
        relevant.append(
            RelevantMessage(
                from_=metadata.source,
                to=metadata.dest,
                timestamp=msg.timestamp,
                message_text=chunks[0] if len(chunks) == 1 else chunks,
            )
        )
        if top_k and len(relevant) >= top_k:
            break
    return relevant


async def get_relevant_topics_for_answer(
    conversation: IConversation,
    search_result: SemanticRefSearchResult,
    top_k: int | None = None,
) -> list[RelevantKnowledge]:
    assert conversation.semantic_refs is not None
    merged = merge_scored_topics(
        await get_scored_semantic_refs_from_ordinals_iter(
            conversation.semantic_refs, search_result.semantic_ref_matches, "topic"
        ),
        merge_ordinals=True,
    )
    candidates: Iterable[Scored[MergedTopic]] = merged.values()
    if top_k and len(merged) > top_k:
        candidates = get_top_k(candidates, top_k)
    return [
        await create_relevant_knowledge(
            conversation, sv.item.topic, sv.item.source_message_ordinals
        )
        for sv in candidates
    ]


async def get_relevant_entities_for_answer(
    conversation: IConversation,
    search_result: SemanticRefSearchResult,
    top_k: int | None = None,
) -> list[RelevantKnowledge]:
    assert conversation.semantic_refs is not None
    merged = merge_scored_concrete_entities(
        await get_scored_semantic_refs_from_ordinals_iter(
            conversation.semantic_refs, search_result.semantic_ref_matches, "entity"
        ),
        merge_ordinals=True,
    )
    candidates: Iterable[Scored[MergedEntity]] = merged.values()
    if top_k and len(merged) > top_k:
        candidates = get_top_k(candidates, top_k)
    return [
        await create_relevant_knowledge(
            conversation,
            merged_to_concrete_entity(sv.item),
            sv.item.source_message_ordinals,
        )
        for sv in candidates
    ]


async def make_context[TMessage: IMessage, TIndex: ITermToSemanticRefIndex](
    search_result: ConversationSearchResult,
    conversation: IConversation[TMessage, TIndex],
    options: AnswerContextOptions | None = None,
) -> AnswerContext:
    context = AnswerContext([], [], [])
    if search_result.message_matches:
        context.messages = await get_relevant_messages_for_answer(
            conversation,
            search_result.message_matches,
            options and options.messages_top_k,
        )
    for knowledge_type, knowledge in search_result.knowledge_matches.items():
        if knowledge_type == "entity":
            context.entities = await get_relevant_entities_for_answer(
                conversation, knowledge, options and options.entities_top_k
            )
        elif knowledge_type == "topic":
            context.topics = await get_relevant_topics_for_answer(
                conversation, knowledge, options and options.topics_top_k
            )
    return context


# ---------------------------------------------------------------------------
# Prompt construction
# ---------------------------------------------------------------------------


def dictify(obj: object) -> Any:
    """Recursively convert to plain dicts/lists, dropping None values."""
    if ann := getattr(obj.__class__, "__annotations__", None):
        return {k: dictify(v) for k in ann if (v := getattr(obj, k, None)) is not None}
    if isinstance(obj, dict):
        return {k: dictify(v) for k, v in obj.items() if v is not None}
    if isinstance(obj, list):
        return [dictify(item) for item in obj]
    if hasattr(obj, "__dict__"):
        return {k: dictify(v) for k, v in obj.__dict__.items() if v is not None}
    if isinstance(obj, float) and obj.is_integer():
        return int(obj)
    return obj


def create_question_prompt(question: str) -> str:
    # Rule text matches the reference verbatim (it IS the stage-4 behavior).
    return "\n".join(
        [
            "The following is a user question:",
            "===",
            question,
            "===",
            "- The included [ANSWER CONTEXT] contains information that MAY be relevant to answering the question.",
            "- Answer the user question PRECISELY using ONLY relevant topics, entities, actions, messages and time ranges/timestamps found in [ANSWER CONTEXT].",
            "- Return 'NoAnswer' if unsure or if the topics and entity names/types in the question are not in [ANSWER CONTEXT].",
            "- Use the 'name', 'type' and 'facets' properties of the provided JSON entities to identify those highly relevant to answering the question.",
            "- When asked for lists, ensure the the list contents answer the question and nothing else.",
            "E.g. for the question 'List all books': List only the books in [ANSWER CONTEXT].",
            "- Use direct quotes only when needed or asked. Otherwise answer in your own words.",
            "- Your answer is readable and complete, with appropriate formatting: line breaks, numbered lists, bullet points etc.",
        ]
    )


def create_context_prompt(context: AnswerContext) -> str:
    import pprint

    return "\n".join(
        [
            "[ANSWER CONTEXT]",
            "===",
            pprint.pformat(dictify(context), width=200),
            "===",
        ]
    )


# ---------------------------------------------------------------------------
# Answer generation
# ---------------------------------------------------------------------------


async def generate_answer[TMessage: IMessage, TIndex: ITermToSemanticRefIndex](
    translator: TypedTranslator[AnswerResponse],
    search_result: ConversationSearchResult,
    conversation: IConversation[TMessage, TIndex],
    options: AnswerContextOptions | None = None,
) -> AnswerResponse:
    assert search_result.raw_query_text is not None, "Raw query text must not be None"
    context = await make_context(search_result, conversation, options)
    request = (
        f"{create_question_prompt(search_result.raw_query_text)}\n\n"
        f"{create_context_prompt(context)}"
    )
    if options and options.debug:
        print("Stage 4 input:")
        print(request)
        print("-" * 50)
    result = await translator.translate(request)
    if isinstance(result, Failure):
        return AnswerResponse(
            type="NoAnswer",
            answer=None,
            why_no_answer=f"Translation failure: {result.message}",
        )
    return result.value


async def _generate_answers_concurrently(
    translator: TypedTranslator[AnswerResponse],
    search_results: list[ConversationSearchResult],
    conversation: IConversation,
    options: AnswerContextOptions | None,
    settings: AnswerGeneratorSettings,
) -> list[AnswerResponse]:
    semaphore = asyncio.Semaphore(max(1, settings.concurrency))
    found_answer = asyncio.Event()

    async def run_one(result: ConversationSearchResult) -> AnswerResponse | None:
        async with semaphore:
            if settings.fast_stop and found_answer.is_set():
                return None
            answer = await generate_answer(translator, result, conversation, options)
            if (
                settings.fast_stop
                and answer.type == "Answered"
                and answer.answer
                and answer.answer.strip()
            ):
                found_answer.set()
            return answer

    results = await asyncio.gather(*(run_one(r) for r in search_results))
    return [a for a in results if a is not None]


async def generate_answers(
    translator: TypedTranslator[AnswerResponse],
    search_results: list[ConversationSearchResult],
    conversation: IConversation,
    orig_query_text: str,
    options: AnswerContextOptions | None = None,
    settings: AnswerGeneratorSettings | None = None,
) -> tuple[list[AnswerResponse], AnswerResponse]:
    """Returns (per-result answers, combined answer). With fast_stop, results
    not yet started when a good answer landed are skipped."""
    settings = settings or AnswerGeneratorSettings()
    all_answers = await _generate_answers_concurrently(
        translator, search_results, conversation, options, settings
    )
    good_answers = [
        stripped
        for answer in all_answers
        if answer.type == "Answered"
        and answer.answer is not None
        and (stripped := answer.answer.strip())
    ]
    if len(all_answers) == 1:
        return all_answers, all_answers[0]
    match len(good_answers):
        case 0:
            combined = AnswerResponse(
                type="NoAnswer", why_no_answer="No good answers found."
            )
        case 1:
            combined = AnswerResponse(type="Answered", answer=good_answers[0])
        case _:
            combined = await combine_answers(
                translator, good_answers, orig_query_text
            )
    return all_answers, combined


async def combine_answers(
    translator: TypedTranslator[AnswerResponse],
    answers: list[str],
    original_query_text: str,
) -> AnswerResponse:
    """Blend multiple partial answers into one."""
    if not answers:
        return AnswerResponse(type="NoAnswer", why_no_answer="No answers provided.")
    if len(answers) == 1:
        return AnswerResponse(type="Answered", answer=answers[0])
    request_parts = [
        "The following are multiple partial answers to the same question.",
        "Combine the partial answers into a single answer to the original question.",
        "Don't just concatenate the answers, but blend them into a single accurate and precise answer.",
        "",
        "*** Original Question ***",
        original_query_text,
        "*** Partial answers ***",
        "===",
    ]
    for answer in answers:
        request_parts.append(answer.strip())
        request_parts.append("===")
    result = await translator.translate("\n".join(request_parts))
    if isinstance(result, Failure):
        return AnswerResponse(type="NoAnswer", why_no_answer=result.message)
    return result.value
