"""ConversationBase: the conversation object with incremental indexing.

The port of ``typeagent_tpu/knowpro/conversation_base.py``. (Parity:
reference knowpro/conversation_base.py — single-transaction batch ingest
ordering: mark sources -> extend messages -> metadata knowledge -> optional
LLM knowledge -> secondary indexes -> timestamps; streaming commits via
precomputed embeddings; the 4-stage query() path.)

The default LLM knowledge extractor and the query translators are built,
as in JAX, over the default HTTP chat model (``settings.chat_retrier``),
configured from the environment.
"""

from __future__ import annotations

import asyncio
from collections.abc import AsyncIterable, Callable, Sequence
from dataclasses import dataclass
from datetime import datetime, timezone
from typing import Generic, Protocol, Self, TypeVar

import numpy as np

from ..models.result import Failure
from ..models.structured import TypedTranslator
from ..utils.trace import span
from . import answers, convknowledge, kplib, searchlang, secindex, semrefindex
from .answer_response_schema import AnswerResponse
from .convsettings import ConversationSettings
from .interfaces import (
    AddMessagesResult,
    IConversation,
    IConversationSecondaryIndexes,
    IMessage,
    IMessageCollection,
    IndexingStartPoints,
    ISemanticRefCollection,
    IStorageProvider,
    ITermToSemanticRefIndex,
    MessageOrdinal,
    TextLocation,
    Topic,
)
from .messageutils import get_all_message_chunk_locations
from .propindex import add_to_property_index
from .search_query_schema import SearchQuery

TMessage = TypeVar("TMessage", bound=IMessage)


class _CommittableChunk(Protocol):
    """Chunk commit payload produced by the streaming pipeline."""

    chunk_id: TextLocation
    chunk_count: int
    message: IMessage
    extracted_knowledge: kplib.KnowledgeResponse | None
    chunk_embedding: np.ndarray | None
    related_terms: list[str] | None
    related_term_embeddings: list[np.ndarray] | None


@dataclass(init=False)
class ConversationBase(
    Generic[TMessage], IConversation[TMessage, ITermToSemanticRefIndex]
):
    settings: ConversationSettings
    storage_provider: IStorageProvider[TMessage]
    name_tag: str
    tags: list[str]
    messages: IMessageCollection[TMessage]
    semantic_refs: ISemanticRefCollection
    semantic_ref_index: ITermToSemanticRefIndex
    secondary_indexes: IConversationSecondaryIndexes[TMessage] | None
    _query_translator: TypedTranslator[SearchQuery] | None = None
    _answer_translator: TypedTranslator[AnswerResponse] | None = None

    def __init__(
        self,
        settings: ConversationSettings,
        name: str,
        tags: list[str],
    ):
        self.settings = settings
        self.name_tag = name
        self.tags = tags
        self._query_translator = None
        self._answer_translator = None

    @classmethod
    async def create(
        cls,
        settings: ConversationSettings,
        name: str | None = None,
        tags: list[str] | None = None,
    ) -> Self:
        provider = await settings.get_storage_provider()
        instance = cls(settings, name or "", list(tags or ()))
        instance.storage_provider = provider
        instance.messages = provider.messages
        instance.semantic_refs = provider.semantic_refs
        instance.semantic_ref_index = provider.semantic_ref_index
        instance.secondary_indexes = secindex.ConversationSecondaryIndexes(
            provider, settings.related_term_index_settings
        )
        return instance

    def _get_secondary_indexes(self) -> IConversationSecondaryIndexes[TMessage]:
        assert self.secondary_indexes is not None, (
            f"Use await {self.__class__.__name__}.create() to create an "
            f"initialized instance"
        )
        return self.secondary_indexes

    async def add_metadata_to_index(self) -> None:
        await semrefindex.add_metadata_to_index(
            self.messages, self.semantic_refs, self.semantic_ref_index
        )

    # -- batch ingest ---------------------------------------------------------

    async def add_messages_with_indexing(
        self,
        messages: list[TMessage],
        *,
        source_ids: list[str] | None = None,
    ) -> AddMessagesResult:
        """Add messages and build all indexes in one transaction.

        SQLite: all-or-nothing (rollback on error). Memory: best-effort.
        Source IDs are marked inside the same transaction so failed ingests
        don't leave sources marked as done.
        """
        storage = await self.settings.get_storage_provider()
        if source_ids is not None and len(source_ids) != len(messages):
            raise ValueError(
                f"Length of source_ids {len(source_ids)} must match length of "
                f"messages {len(messages)}"
            )

        with span("ingest.batch", messages=len(messages)):
            return await self._indexed_ingest(
                storage, messages, source_ids
            )

    async def _indexed_ingest(
        self,
        storage: IStorageProvider[TMessage],
        messages: list[TMessage],
        source_ids: list[str] | None,
    ) -> AddMessagesResult:
        async with storage:
            if source_ids is not None:
                sids = source_ids
            else:
                sids = [m.source_id for m in messages if m.source_id is not None]
            if sids:
                await storage.mark_sources_ingested_batch(sids)

            start_points = await self._index_watermarks()

            # One span per stage (under "ingest.batch"), so that the ingest
            # rate can be split: embedding the chunks into the message
            # index, the metadata knowledge, extraction, the other indexes.
            with span("messages"):
                await self._catch_up_message_index(start_points.message_count)
                await self.messages.extend(messages)
            with span("metadata"):
                await self._fold_in_metadata_knowledge(start_points.message_count)

            if self.settings.semantic_ref_index_settings.auto_extract_knowledge:
                with span("extract"):
                    await self._fold_in_llm_knowledge(
                        messages, start_points.message_count
                    )

            with span("indexes"):
                await self._advance_secondary_indexes(start_points)
            await storage.update_conversation_timestamps(
                updated_at=datetime.now(timezone.utc)
            )
            return await self._delta_result(start_points, messages)

    async def add_messages_streaming(
        self,
        messages: AsyncIterable[TMessage],
        *,
        batch_size: int = 100,
        on_batch_committed: Callable[[AddMessagesResult], None] | None = None,
        skip_failed_messages: bool = False,
        shutdown_event: asyncio.Event | None = None,
    ) -> AddMessagesResult:
        from .add_messages import add_messages_streaming as run_pipeline

        with span("ingest.streaming", batch_size=batch_size):
            return await run_pipeline(
                self,
                messages,
                batch_size=batch_size,
                on_batch_committed=on_batch_committed,
                skip_failed_messages=skip_failed_messages,
                shutdown_event=shutdown_event,
            )

    async def _commit_chunk_batch(
        self,
        storage: IStorageProvider[TMessage],
        messages_batch: list[TMessage],
        chunk_results: Sequence[_CommittableChunk],
    ) -> AddMessagesResult:
        """Commit one pipeline batch with precomputed extraction + embeddings."""
        if not messages_batch:
            return AddMessagesResult()

        # Pipeline chunk ids carry the producer's message ordinals. When
        # skip_failed_messages dropped messages, gaps form: remap each chunk
        # result onto its message's batch position (by identity — zero-chunk
        # messages have no chunk results at all), so storage ordinals line up.
        # (The reference keys commits by raw pipeline ordinals, which breaks
        # after a skip.)
        pos_by_msg = {id(m): i for i, m in enumerate(messages_batch)}

        def _ordinal_in_batch(result: _CommittableChunk) -> int:
            pos = pos_by_msg.get(id(result.message))
            if pos is None:
                raise ValueError(
                    "Chunk result for a message not in this batch: "
                    f"pipeline ordinal {result.chunk_id.message_ordinal}"
                )
            return pos

        knowledge_items: list[tuple[MessageOrdinal, int, kplib.KnowledgeResponse]] = []
        fuzzy_terms: list[str] = []
        fuzzy_term_embeddings: list[np.ndarray] = []
        chunk_embedding_map: dict[tuple[int, int], np.ndarray] = {}

        for result in chunk_results:
            if result.chunk_count == 0:
                continue
            where = (
                f"message={result.chunk_id.message_ordinal}, "
                f"chunk={result.chunk_id.chunk_ordinal}"
            )
            if result.chunk_embedding is None:
                raise ValueError(f"Chunk result missing chunk embedding for {where}")
            if result.extracted_knowledge is None:
                raise ValueError(f"Chunk result missing extracted knowledge for {where}")
            knowledge_items.append(
                (
                    _ordinal_in_batch(result),
                    result.chunk_id.chunk_ordinal,
                    result.extracted_knowledge,
                )
            )
            if result.related_terms is None or result.related_term_embeddings is None:
                raise ValueError(
                    f"Chunk result missing related-term embeddings for {where}"
                )
            if len(result.related_terms) != len(result.related_term_embeddings):
                raise ValueError(
                    f"related_terms and related_term_embeddings length mismatch "
                    f"for {where}: {len(result.related_terms)} != "
                    f"{len(result.related_term_embeddings)}"
                )
            fuzzy_terms.extend(result.related_terms)
            fuzzy_term_embeddings.extend(result.related_term_embeddings)
            chunk_embedding_map[
                (_ordinal_in_batch(result), result.chunk_id.chunk_ordinal)
            ] = result.chunk_embedding

        async with storage:
            start_points = await self._index_watermarks()
            await self._catch_up_message_index(start_points.message_count)

            chunk_embeddings: list[np.ndarray] = []
            for batch_pos, message in enumerate(messages_batch):
                for chunk_ord in range(len(message.text_chunks)):
                    embedding = chunk_embedding_map.get((batch_pos, chunk_ord))
                    if embedding is None:
                        raise ValueError(
                            "Missing chunk embedding for staged message chunk: "
                            f"batch position={batch_pos}, chunk={chunk_ord}"
                        )
                    chunk_embeddings.append(embedding)

            await self.messages.extend(messages_batch, chunk_embeddings=chunk_embeddings)
            source_ids = [m.source_id for m in messages_batch if m.source_id is not None]
            if source_ids:
                await storage.mark_sources_ingested_batch(source_ids)

            await self._fold_in_metadata_knowledge(start_points.message_count)
            await semrefindex.add_knowledge_batch_to_semantic_ref_index(
                self,
                [
                    (start_points.message_count + pos, chunk_ord, kr)
                    for pos, chunk_ord, kr in knowledge_items
                ],
            )
            await self._advance_indexes_with_embeddings(
                start_points, messages_batch, fuzzy_terms, fuzzy_term_embeddings
            )
            await storage.update_conversation_timestamps(
                updated_at=datetime.now(timezone.utc)
            )
            return await self._delta_result(start_points, messages_batch)

    async def _delta_result(
        self, start_points: IndexingStartPoints, batch: list[TMessage]
    ) -> AddMessagesResult:
        """Tally what an ingest actually landed relative to its start points."""
        messages_added = await self.messages.size() - start_points.message_count
        return AddMessagesResult(
            messages_added=messages_added,
            chunks_added=sum(len(m.text_chunks) for m in batch[:messages_added]),
            semrefs_added=(
                await self.semantic_refs.size() - start_points.semref_count
            ),
        )

    async def _index_watermarks(self) -> IndexingStartPoints:
        return IndexingStartPoints(
            message_count=await self.messages.size(),
            semref_count=await self.semantic_refs.size(),
        )

    # -- incremental index helpers ----------------------------------------------

    async def _advance_indexes_with_embeddings(
        self,
        start_points: IndexingStartPoints,
        new_messages: list[TMessage],
        related_terms: list[str],
        related_term_embeddings: list[np.ndarray],
    ) -> None:
        if self.secondary_indexes is None:
            return
        await add_to_property_index(self, start_points.semref_count)
        await self._index_message_timestamps(
            new_messages, start_points.message_count
        )
        term_to_related = self.secondary_indexes.term_to_related_terms_index
        if term_to_related is not None:
            fuzzy_index = term_to_related.fuzzy_index
            if fuzzy_index is not None and related_terms:
                await fuzzy_index.add_terms_with_embeddings(
                    related_terms, related_term_embeddings
                )

    async def _fold_in_metadata_knowledge(
        self, start_from_message_ordinal: int
    ) -> None:
        messages_slice = await self.messages.get_slice(
            start_from_message_ordinal, 999_999_999
        )
        await semrefindex.add_metadata_to_index_from_list(
            messages_slice,
            self.semantic_refs,
            self.semantic_ref_index,
            start_from_message_ordinal,
        )

    async def _fold_in_llm_knowledge(
        self,
        messages: list[TMessage],
        start_from_message_ordinal: int,
    ) -> None:
        settings = self.settings.semantic_ref_index_settings
        if not settings.auto_extract_knowledge:
            return
        knowledge_extractor = (
            settings.knowledge_extractor or convknowledge.KnowledgeExtractor()
        )
        text_locations = get_all_message_chunk_locations(
            messages, start_from_message_ordinal
        )
        await semrefindex.add_batch_to_semantic_ref_index_from_list(
            self,
            messages,
            text_locations,
            knowledge_extractor,
            concurrency=settings.concurrency,
        )

    async def _advance_secondary_indexes(
        self, start_points: IndexingStartPoints
    ) -> None:
        if self.secondary_indexes is None:
            return
        await add_to_property_index(self, start_points.semref_count)
        new_messages = await self.messages.get_slice(
            start_points.message_count, 999_999_999
        )
        await self._index_message_timestamps(
            new_messages, start_points.message_count
        )
        await self._advance_related_terms(start_points.semref_count)
        await self._advance_message_index(
            new_messages, start_points.message_count
        )

    async def _index_message_timestamps(
        self,
        messages: list[TMessage],
        start_ordinal: MessageOrdinal,
    ) -> None:
        if (
            self.secondary_indexes is None
            or self.secondary_indexes.timestamp_index is None
        ):
            return
        timestamp_data = [
            (i, msg.timestamp)
            for i, msg in enumerate(messages, start_ordinal)
            if msg.timestamp
        ]
        if timestamp_data:
            await self.secondary_indexes.timestamp_index.add_timestamps(timestamp_data)

    async def _advance_related_terms(
        self, start_from_semref_ordinal: int
    ) -> None:
        if (
            self.secondary_indexes is None
            or self.secondary_indexes.term_to_related_terms_index is None
        ):
            return
        new_semrefs = await self.semantic_refs.get_slice(
            start_from_semref_ordinal, 999_999_999
        )
        fuzzy_index = self.secondary_indexes.term_to_related_terms_index.fuzzy_index
        if fuzzy_index is None or not new_semrefs:
            return

        def terms_of(knowledge) -> list[str]:
            if isinstance(knowledge, kplib.ConcreteEntity):
                return [knowledge.name]
            if isinstance(knowledge, Topic):
                return [knowledge.text]
            if isinstance(knowledge, kplib.Action):
                return list(knowledge.verbs)
            return []

        new_terms = {
            t.lower() for semref in new_semrefs for t in terms_of(semref.knowledge)
        }
        if new_terms:
            await fuzzy_index.add_terms(list(new_terms))

    async def _catch_up_message_index(self, collection_size: int) -> None:
        """Index any trailing messages the text index hasn't seen yet.

        Snapshot loads (`convfiles.py`) and bulk loaders extend the message
        collection with ``index_messages=False``, leaving the text index
        behind the collection. This must run BEFORE the next indexed extend:
        the extend feeds the index at the new messages' true ordinals, after
        which ``indexed_message_count`` (max-ordinal based) can no longer
        see the missing prefix.
        """
        if (
            self.secondary_indexes is None
            or self.secondary_indexes.message_index is None
        ):
            return
        index = self.secondary_indexes.message_index
        indexed = await index.indexed_message_count()
        if indexed >= collection_size:
            return
        lagging = await self.messages.get_slice(indexed, collection_size)
        await index.add_messages_starting_at(indexed, list(lagging))

    async def _advance_message_index(
        self,
        new_messages: list[TMessage],
        start_ordinal: MessageOrdinal,
    ) -> None:
        """Safety net: index this batch's tail if the extend didn't.

        Both collection backends feed the text index during ``extend``, so
        normally the index is already at ``start_ordinal + len(new_messages)``
        and this is a no-op. ``new_messages`` is a TAIL SLICE starting at
        global ordinal ``start_ordinal``, so rebase by the index's own
        count rather than passing the slice to ``add_messages`` (which
        skips by indexed count assuming the FULL message list).
        """
        if (
            self.secondary_indexes is None
            or self.secondary_indexes.message_index is None
        ):
            return
        index = self.secondary_indexes.message_index
        indexed = await index.indexed_message_count()
        end_ordinal = start_ordinal + len(new_messages)
        if indexed >= end_ordinal or indexed < start_ordinal:
            return
        await index.add_messages_starting_at(
            indexed, list(new_messages[indexed - start_ordinal :])
        )

    # -- the 4-stage query path ----------------------------------------------

    def _lazy_translators(self) -> None:
        """Lazy stage-1/stage-4 translators over the configured chat model."""
        if self._query_translator is not None and self._answer_translator is not None:
            return
        from ..models.adapters import create_chat_model

        if self._query_translator is None:
            self._query_translator = searchlang.create_search_query_translator(
                create_chat_model(retrier=self.settings.chat_retrier)
            )
        if self._answer_translator is None:
            self._answer_translator = answers.create_answer_translator(
                create_chat_model(retrier=self.settings.chat_retrier)
            )

    async def query(
        self,
        question: str,
        search_options: searchlang.LanguageSearchOptions | None = None,
        answer_options: answers.AnswerContextOptions | None = None,
        debug_context: searchlang.LanguageSearchDebugContext | None = None,
    ) -> str:
        """End-to-end natural-language query -> answer string.

        ``debug_context`` captures the per-stage intermediates (stage-1
        SearchQuery, compiled exprs, stage-3 results) for batch recorders
        (reference tools/query.py's --search-results flow).
        """
        self._lazy_translators()

        search_options = search_options or searchlang.LanguageSearchOptions(
            compile_options=searchlang.LanguageQueryCompileOptions(
                exact_scope=False,
                verb_scope=True,
                term_filter=None,
                apply_scope=True,
            ),
            exact_match=False,
            max_message_matches=25,
        )

        with span("query.translate_and_search"):
            result = await searchlang.search_conversation_with_language(
                self,
                self._query_translator,
                question,
                search_options,
                debug_context=debug_context,
            )
        if isinstance(result, Failure):
            return f"Search failed: {result.message}"
        search_results = result.value

        answer_options = answer_options or answers.AnswerContextOptions(
            entities_top_k=50, topics_top_k=50, messages_top_k=None, chunking=None
        )

        with span("query.answers", results=len(search_results)):
            _, combined_answer = await answers.generate_answers(
                self._answer_translator,
                search_results,
                self,
                question,
                options=answer_options,
            )

        match combined_answer.type:
            case "NoAnswer":
                return (
                    f"No answer found: "
                    f"{combined_answer.why_no_answer or 'Unable to find relevant information'}"
                )
            case "Answered":
                return combined_answer.answer or "No answer provided"
            case _:
                return f"Unexpected answer type: {combined_answer.type}"
