"""Shared snapshot (de)serialization for conversation subclasses.

The port of ``typeagent_tpu/knowpro/convfiles.py``: a snapshot written by
either package loads in the other (same ``_data.json`` keys, same raw f32
``_embeddings.bin``).

The reference duplicates this logic in Podcast/Transcript
(`podcasts/podcast.py:258-400`, `transcripts/transcript.py`); here it's one
mixin: serialize the full conversation (messages, semrefs, six indexes) to
the camelCase JSON + binary sidecar format and load it back into an empty
conversation.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Self

from ..storage.memory.indexes import ConversationThreads
from . import secindex, serialization
from .interfaces import ConversationDataWithIndexes, SemanticRef

if TYPE_CHECKING:
    from .convsettings import ConversationSettings


def _has_embeddings(embeddings) -> bool:
    return embeddings is not None and len(embeddings) > 0


class FileSerializedConversation:
    """Mixin for ConversationBase subclasses: snapshot to/from files."""

    message_type: type | None = None  # subclasses set their message class

    async def serialize(self) -> ConversationDataWithIndexes[Any]:
        data: ConversationDataWithIndexes[Any] = ConversationDataWithIndexes(
            nameTag=self.name_tag,
            messages=[m.serialize() async for m in self.messages],
            tags=self.tags,
            semanticRefs=(
                [r.serialize() async for r in self.semantic_refs]
                if self.semantic_refs is not None
                else None
            ),
        )
        data["semanticIndexData"] = await self.semantic_ref_index.serialize()
        secondary_indexes = self._get_secondary_indexes()
        if secondary_indexes.term_to_related_terms_index is not None:
            data["relatedTermsIndexData"] = (
                await secondary_indexes.term_to_related_terms_index.serialize()
            )
        if secondary_indexes.threads:
            data["threadData"] = secondary_indexes.threads.serialize()
        if secondary_indexes.message_index is not None:
            data["messageIndexData"] = await secondary_indexes.message_index.serialize()
        return data

    async def write_to_file(self, filename: str) -> None:
        data = await self.serialize()
        serialization.write_conversation_data_to_file(data, filename)

    async def deserialize(self, data: ConversationDataWithIndexes[Any]) -> None:
        """Load a snapshot into this (empty) conversation."""
        if await self.messages.size() or (
            self.semantic_refs is not None and await self.semantic_refs.size()
        ):
            raise RuntimeError(
                f"Cannot deserialize into a non-empty {type(self).__name__}."
            )

        self.name_tag = data["nameTag"]
        messages = [self._deserialize_message(m) for m in data["messages"]]
        # The message index snapshot replaces any incremental indexing.
        await self.messages.extend(messages, index_messages=False)

        semantic_refs_data = data.get("semanticRefs")
        if semantic_refs_data is not None:
            await self.semantic_refs.extend(
                [SemanticRef.deserialize(r) for r in semantic_refs_data]
            )

        self.tags = data["tags"]

        semantic_index_data = data.get("semanticIndexData")
        if semantic_index_data is not None:
            await self.semantic_ref_index.deserialize(semantic_index_data)

        secondary_indexes = self._get_secondary_indexes()
        related_terms_index_data = data.get("relatedTermsIndexData")
        if related_terms_index_data is not None:
            index = secondary_indexes.term_to_related_terms_index
            if index is not None:
                assert await index.aliases.is_empty(), (
                    "Term to related terms index must be empty before deserializing"
                )
                text_embedding_data = related_terms_index_data.get(
                    "textEmbeddingData"
                )
                if text_embedding_data is not None and not _has_embeddings(
                    text_embedding_data.get("embeddings")
                ):
                    # Snapshot without an embedding sidecar (e.g. the
                    # reference's Episode-53 fixture): re-embed the term
                    # texts through the model instead.
                    texts = text_embedding_data.get("textItems") or []
                    related_terms_index_data = dict(related_terms_index_data)
                    related_terms_index_data.pop("textEmbeddingData", None)
                    await index.deserialize(related_terms_index_data)
                    if texts and index.fuzzy_index is not None:
                        await index.fuzzy_index.add_terms(texts)
                else:
                    await index.deserialize(related_terms_index_data)

        thread_data = data.get("threadData")
        if thread_data is not None:
            assert self.settings is not None
            secondary_indexes.threads = ConversationThreads(
                self.settings.thread_settings
            )
            secondary_indexes.threads.deserialize(thread_data)

        message_index_data = data.get("messageIndexData")
        if message_index_data is not None:
            assert secondary_indexes.message_index is not None
            index_data = message_index_data.get("indexData") or {}
            if not _has_embeddings(index_data.get("embeddings")):
                # No sidecar embeddings: re-embed all message chunks.
                if messages:
                    await secondary_indexes.message_index.add_messages_starting_at(
                        0, messages
                    )
            else:
                await secondary_indexes.message_index.deserialize(message_index_data)

        await self._after_deserialize(related_terms_index_data is None)
        await secindex.build_transient_secondary_indexes(self, self.settings)

    async def _after_deserialize(self, rebuild_related_terms: bool) -> None:
        """Hook for subclasses (e.g. participant aliases / verb synonyms)."""

    def _deserialize_message(self, message_data: Any):
        if self.message_type is None:
            raise TypeError(
                f"{type(self).__name__} must set message_type for deserialization"
            )
        return serialization.deserialize_object(self.message_type, message_data)

    @classmethod
    async def read_from_file(
        cls,
        filename_prefix: str,
        settings: ConversationSettings,
        dbname: str | None = None,
    ) -> Self:
        data = serialization.read_conversation_data_from_file(filename_prefix)
        provider = await settings.get_storage_provider()
        if await provider.messages.size() or await provider.semantic_refs.size():
            raise RuntimeError(
                f"Database {dbname!r} already has messages or semantic refs."
            )
        conversation = await cls.create(settings)
        await conversation.deserialize(data)
        return conversation
