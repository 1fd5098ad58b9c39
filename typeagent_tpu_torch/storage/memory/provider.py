"""In-memory storage provider: 2 collections + all 6 indexes.

The port of ``typeagent_tpu/storage/memory/provider.py``. (Parity: reference storage/memory/provider.py — transactions are no-ops;
tracks ingested sources + chunk failures in host structures.)
"""

from __future__ import annotations

from types import TracebackType

from datetime import datetime, timezone

from ...knowpro.convsettings import MessageTextIndexSettings, RelatedTermIndexSettings
from ...knowpro.interfaces import (
    ChunkFailure,
    ConversationMetadata,
    IConversationThreads,
    IMessage,
    IMessageTextIndex,
    IPropertyToSemanticRefIndex,
    IStorageProvider,
    ITermToRelatedTermsIndex,
    ITermToSemanticRefIndex,
    ITimestampToTextRangeIndex,
    STATUS_INGESTED,
)
from .collections import MemoryMessageCollection, MemorySemanticRefCollection
from .indexes import (
    ConversationThreads,
    PropertyIndex,
    TermToSemanticRefIndex,
    TimestampToTextRangeIndex,
)
from .messageindex import MessageTextIndex
from .reltermsindex import RelatedTermsIndex


class MemoryStorageProvider[TMessage: IMessage](IStorageProvider[TMessage]):
    """A storage provider that operates in memory (embeddings on the settings' device)."""

    def __init__(
        self,
        message_text_settings: MessageTextIndexSettings,
        related_terms_settings: RelatedTermIndexSettings,
        metadata: ConversationMetadata | None = None,
    ) -> None:
        self._metadata = metadata or ConversationMetadata()
        self._msg_text = MessageTextIndex(message_text_settings)
        self._msgs = MemoryMessageCollection[TMessage](
            message_text_index=self._msg_text
        )
        self._semrefs = MemorySemanticRefCollection()
        self._term_index = TermToSemanticRefIndex()
        self._props = PropertyIndex()
        self._times = TimestampToTextRangeIndex()
        self._rel_terms = RelatedTermsIndex(related_terms_settings)
        self._threads = ConversationThreads(
            message_text_settings.embedding_index_settings
        )
        self._seen_sources: set[str] = set()
        self._failures: dict[tuple[int, int], ChunkFailure] = {}

    # -- transactions (no-ops in memory) -------------------------------------

    async def __aenter__(self) -> "MemoryStorageProvider[TMessage]":
        return self

    async def __aexit__(
        self,
        exc_type: type[BaseException] | None,
        exc_val: BaseException | None,
        exc_tb: TracebackType | None,
    ) -> None:
        pass

    async def close(self) -> None:
        pass

    # -- collections + indexes ------------------------------------------------

    @property
    def messages(self) -> MemoryMessageCollection[TMessage]:
        return self._msgs

    @property
    def semantic_refs(self) -> MemorySemanticRefCollection:
        return self._semrefs

    @property
    def semantic_ref_index(self) -> ITermToSemanticRefIndex:
        return self._term_index

    @property
    def property_index(self) -> IPropertyToSemanticRefIndex:
        return self._props

    @property
    def timestamp_index(self) -> ITimestampToTextRangeIndex:
        return self._times

    @property
    def message_text_index(self) -> IMessageTextIndex[TMessage]:
        return self._msg_text

    @property
    def related_terms_index(self) -> ITermToRelatedTermsIndex:
        return self._rel_terms

    @property
    def conversation_threads(self) -> IConversationThreads:
        return self._threads

    # -- metadata --------------------------------------------------------------

    async def get_conversation_metadata(self) -> ConversationMetadata:
        return self._metadata

    async def set_conversation_metadata(self, **kwds: str | list[str] | None) -> None:
        pass  # API compat: in-memory storage does not persist arbitrary keys

    async def update_conversation_timestamps(
        self,
        created_at: datetime | None = None,
        updated_at: datetime | None = None,
    ) -> None:
        # Tracked on the in-memory metadata object (lost with the process,
        # like everything else here); the sqlite provider persists them.
        if created_at is not None:
            self._metadata.created_at = created_at
        if updated_at is not None:
            self._metadata.updated_at = updated_at

    # -- source-ingestion tracking ----------------------------------------------

    async def is_source_ingested(self, source_id: str) -> bool:
        return source_id in self._seen_sources

    async def are_sources_ingested(self, source_ids: list[str]) -> set[str]:
        return self._seen_sources & set(source_ids)

    async def get_source_status(self, source_id: str) -> str | None:
        return STATUS_INGESTED if source_id in self._seen_sources else None

    async def mark_source_ingested(
        self, source_id: str, status: str = STATUS_INGESTED
    ) -> None:
        self._seen_sources.add(source_id)

    async def mark_sources_ingested_batch(
        self, source_ids: list[str], status: str = STATUS_INGESTED
    ) -> None:
        self._seen_sources.update(source_ids)

    # -- chunk-failure tracking ---------------------------------------------------

    async def record_chunk_failure(
        self,
        message_ordinal: int,
        chunk_ordinal: int,
        error_class: str,
        error_message: str,
    ) -> None:
        self._failures[(message_ordinal, chunk_ordinal)] = ChunkFailure(
            message_ordinal=message_ordinal,
            chunk_ordinal=chunk_ordinal,
            error_class=error_class,
            error_message=error_message,
            failed_at=datetime.now(timezone.utc),
        )

    async def clear_chunk_failure(
        self, message_ordinal: int, chunk_ordinal: int
    ) -> None:
        self._failures.pop((message_ordinal, chunk_ordinal), None)

    async def get_chunk_failures(self) -> list[ChunkFailure]:
        return [self._failures[k] for k in sorted(self._failures)]
